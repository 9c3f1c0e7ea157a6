"""The port stands alone: it imports neither JAX nor the reference package
(nor ``msgpack``: its checkpoints carry their own codec),
its entry points refuse a host without a card unless asked for the CPU,
and a kernel wrapper given a CUDA tensor launches its kernel or raises —
it never runs the plain version in the kernel's place."""
import ast
import dataclasses
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np                                           # noqa: E402

from repro_torch.bench import common                         # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,       # noqa: E402
                                    load_pytree, save_pytree)
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.core import (InGraphEpidemicLocalStrategy,  # noqa: E402
                              InGraphEpidemicStrategy,
                              InGraphFullyConnectedStrategy,
                              InGraphMorphStrategy, InGraphStaticStrategy,
                              MorphConfig, MorphProtocol)
from repro_torch.data import (DeviceDataStream,              # noqa: E402
                              make_image_classification)
from repro_torch.dlrt import (DecentralizedRunner,          # noqa: E402
                              RunnerConfig, init_mesh_caches,
                              init_train_state)
from repro_torch.kernels import (cuda, graph_mix,            # noqa: E402
                                 graph_mix_masked, graph_mix_sparse,
                                 gram_matrix, ref, selective_scan,
                                 selective_scan_bwd)
from repro_torch.launch import (MeshLayout, make_sweep_mesh,  # noqa: E402
                                start)
from repro_torch.launch import train as train_launcher       # noqa: E402
from repro_torch.models import cnn_loss, cnn_params          # noqa: E402
from repro_torch.netsim import AsyncConfig, AsyncRunner      # noqa: E402
from repro_torch.models import mamba as zoo_mamba            # noqa: E402
from repro_torch.models import model as zoo_model            # noqa: E402
from repro_torch.optim import sgd                            # noqa: E402
from repro_torch.sparse import (SparseEpidemicStrategy,      # noqa: E402
                                SparseMorphStrategy)
from repro_torch.tree import tree_map                        # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), \
            f"{path.relative_to(ROOT)} imports {mod}"


ENTRY_POINTS = ("runner", "host-loop-runner", "run-experiment", "morph",
                "static", "el-oracle", "el-local", "fully-connected",
                "stream", "sparse-morph", "sparse-epidemic",
                "zoo-init-params", "zoo-init-cache", "async-runner",
                "train-state", "train-launcher", "moe-init-params",
                "moe-init-cache", "rwkv-init-params", "rwkv-init-cache",
                "moe-train-launcher", "load-checkpoint",
                "restore-checkpoint", "start-ranks", "mesh-caches",
                "sweep-mesh")


def _checkpoint_file() -> str:
    """A checkpoint written on the CPU, in a fresh temporary directory."""
    path = str(Path(tempfile.mkdtemp()) / "ckpt_00000001.msgpack.zst")
    save_pytree(path, {"w": torch.ones(2)})
    return path


def _jamba_reduced():
    cfg = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(
        cfg, moe=None, pattern=tuple(dataclasses.replace(s, moe=False)
                                     for s in cfg.pattern)).reduced()


def _make_entry_point(name):
    ds = make_image_classification(40, image_size=8, seed=0)
    parts = [np.arange(0, 20), np.arange(20, 40)]
    return {
        "runner": lambda: DecentralizedRunner(
            init_fn=lambda g: cnn_params(g, image_size=8, width=4),
            loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(0.1),
            batcher=None, test_batch={"labels": np.zeros(2, np.int32)},
            strategy=None, cfg=RunnerConfig(n_nodes=2, rounds=1)),
        "host-loop-runner": lambda: DecentralizedRunner(
            init_fn=lambda g: cnn_params(g, image_size=8, width=4),
            loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(0.1),
            batcher=None, test_batch={"labels": np.zeros(2, np.int32)},
            strategy=MorphProtocol(MorphConfig(n=2, k=1)),
            cfg=RunnerConfig(n_nodes=2, rounds=1, compiled=False)),
        "run-experiment": lambda: common.run_experiment(
            "morph", common.ExpConfig(n_nodes=2, k=1, rounds=1,
                                      n_samples=40, image_size=8, width=4)),
        "morph": lambda: InGraphMorphStrategy(n=4, k=2),
        "static": lambda: InGraphStaticStrategy(n=4, degree=2),
        "el-oracle": lambda: InGraphEpidemicStrategy(n=4, k=2),
        "el-local": lambda: InGraphEpidemicLocalStrategy(n=4, k=2),
        "fully-connected": lambda: InGraphFullyConnectedStrategy(n=4),
        "stream": lambda: DeviceDataStream(ds, parts, 4),
        "sparse-morph": lambda: SparseMorphStrategy(n=4, k=2),
        "sparse-epidemic": lambda: SparseEpidemicStrategy(n=4, k=2),
        "zoo-init-params": lambda: zoo_model.init_params(_jamba_reduced(), 0),
        "zoo-init-cache": lambda: zoo_model.init_cache(_jamba_reduced(), 1, 4),
        "train-state": lambda: init_train_state(
            get_config("llama3.2-3b").reduced(), sgd(0.1), 2),
        "train-launcher": lambda: train_launcher.main(
            ["--reduced", "--nodes", "2", "--rounds", "1"]),
        "moe-init-params": lambda: zoo_model.init_params(
            get_config("deepseek-moe-16b").reduced(), 0),
        "moe-init-cache": lambda: zoo_model.init_cache(
            get_config("deepseek-moe-16b").reduced(), 1, 4),
        "rwkv-init-params": lambda: zoo_model.init_params(
            get_config("rwkv6-7b").reduced(), 0),
        "rwkv-init-cache": lambda: zoo_model.init_cache(
            get_config("rwkv6-7b").reduced(), 1, 4),
        "moe-train-launcher": lambda: train_launcher.main(
            ["--arch", "jamba-1.5-large-398b", "--reduced", "--nodes", "2",
             "--rounds", "1"]),
        "load-checkpoint": lambda: load_pytree(_checkpoint_file()),
        "restore-checkpoint": lambda: CheckpointManager(
            str(Path(_checkpoint_file()).parent)).restore(),
        "start-ranks": lambda: start(print, 2),
        # Raises naming the card before it looks for a process group.
        "sweep-mesh": lambda: make_sweep_mesh(1, 1),
        # Raises naming the card before it touches the (absent) mesh.
        "mesh-caches": lambda: init_mesh_caches(
            get_config("llama3.2-3b").reduced(), 2, 1, 4,
            MeshLayout(("data", "model"), (1, 1)), None),
        "async-runner": lambda: AsyncRunner(
            init_fn=lambda g: cnn_params(g, image_size=8, width=4),
            loss_fn=cnn_loss, eval_fn=cnn_loss, optimizer=sgd(0.1),
            batcher=None, test_batch={"labels": np.zeros(2, np.int32)},
            strategy=MorphProtocol(MorphConfig(n=2, k=1)),
            cfg=AsyncConfig(n_nodes=2, rounds=1)),
    }[name]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _make_entry_point(name)()


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts calls of the plain versions."""
    calls = []
    for fn in ("gram_matrix", "graph_mix", "graph_mix_masked",
               "graph_mix_sparse", "selective_scan"):
        orig = getattr(ref, fn)
        monkeypatch.setattr(ref, fn, lambda *a, _o=orig, _f=fn:
                            calls.append(_f) or _o(*a))
    return calls


def _cuda_path_calls():
    """Each wrapper on ``meta`` tensors, which stand for tensors off the
    CPU: they take the kernel path."""
    x = torch.empty((5, 70), device="meta")
    w = torch.empty((5, 5), device="meta")
    e = torch.empty((5, 5), dtype=torch.bool, device="meta")
    idx = torch.empty((5, 3), dtype=torch.int32, device="meta")
    ws = torch.empty((5, 3), device="meta")
    w_self = torch.empty((5,), device="meta")
    seq = torch.empty((2, 9, 70), device="meta")
    bc = torch.empty((2, 9, 16), device="meta")
    a = torch.empty((70, 16), device="meta")
    h0 = torch.empty((2, 70, 16), device="meta")
    return [(gram_matrix, (x,)), (graph_mix, (w, x)),
            (graph_mix_masked, (e, x)),
            (graph_mix_sparse, (idx, ws, w_self, x)),
            (selective_scan, (seq, seq, bc, bc, a, h0))]


def test_kernel_path_raises_instead_of_falling_back(plain_calls):
    for wrapper, args in _cuda_path_calls():
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(*args)
    assert plain_calls == []


def test_kernel_path_launches_and_counts(plain_calls, monkeypatch):
    launched = []

    class FakeLibrary:
        def __getattr__(self, fn):
            return lambda *args: launched.append(fn) or 0

    monkeypatch.setattr(cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(cuda, "library", lambda *a: FakeLibrary())
    monkeypatch.setattr(cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(cuda, "sm_count", lambda device: 132)
    before = [w.launches for w, _ in _cuda_path_calls()]
    for wrapper, args in _cuda_path_calls():
        wrapper(*args)
    assert launched == ["gram_f32", "graph_mix_f32", "graph_mix_masked_f32",
                        "graph_mix_sparse_f32", "selective_scan"]
    assert [w.launches - b for (w, _), b in
            zip(_cuda_path_calls(), before)] == [1, 1, 1, 1, 1]
    assert plain_calls == []


def test_mamba_prefill_takes_the_kernel_path(plain_calls):
    """``apply_mamba`` on tensors off the CPU reaches the scan kernel's
    wrapper, which raises here: it never runs the plain scan instead."""
    cfg = _jamba_reduced()
    spec = next(i for i, s in enumerate(cfg.pattern) if s.mixer == "mamba")
    params = zoo_model.init_params(cfg, 0, device="cpu")
    mixer = tree_map(lambda t: t[0].to("meta"), params["body"][spec]["mixer"])
    x = torch.empty((2, 32, cfg.d_model), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        zoo_mamba.apply_mamba(mixer, x, cfg)
    assert plain_calls == []


def test_scan_backward_takes_the_kernel_path(plain_calls, monkeypatch):
    """The scan's backward on tensors off the CPU launches its kernel (one
    count a call) or raises, and autograd through the scan there goes
    through it: never autograd through the plain scan."""
    seq = torch.empty((2, 9, 70), device="meta")
    bc = torch.empty((2, 9, 16), device="meta")
    a = torch.empty((70, 16), device="meta")
    h0 = torch.empty((2, 70, 16), device="meta")
    tiles = torch.empty((2, 2, 70, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_bwd(seq, seq, bc, bc, a, h0, seq, None, tiles)
    assert plain_calls == []

    launched = []

    class FakeLibrary:
        def __getattr__(self, fn):
            if fn == "selective_scan_bwd_channels":
                return lambda ds: 64
            return lambda *args: launched.append(fn) or 0

    monkeypatch.setattr(cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(cuda, "library", lambda *a: FakeLibrary())
    monkeypatch.setattr(cuda, "stream_handle", lambda device: 0)
    fwd, bwd = selective_scan.launches, selective_scan_bwd.launches
    grads = selective_scan_bwd(seq, seq, bc, bc, a, h0, seq, None, tiles)
    assert launched == ["selective_scan_bwd"]
    assert (selective_scan.launches - fwd,
            selective_scan_bwd.launches - bwd) == (0, 1)
    assert [g.shape for g in grads] == [seq.shape, seq.shape, bc.shape,
                                        bc.shape, a.shape, h0.shape]

    launched.clear()
    x = seq.clone().requires_grad_()
    y, _ = selective_scan(x, seq, bc, bc, a, h0)
    y.sum().backward()
    assert launched == ["selective_scan", "selective_scan_bwd"]
    assert x.grad.shape == seq.shape
    assert plain_calls == []
