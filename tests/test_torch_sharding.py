"""The zoo's sharding policies, production mesh and dry run
(``repro_torch.dlrt.distributed``, ``launch.mesh``, ``launch.dryrun``)
against the reference's (``repro.dlrt.distributed`` on
``jax.sharding.AbstractMesh``), on the CPU with no device.

For every ``ASSIGNED`` architecture at full width, every input shape's
``shape_config`` and both production meshes: the port's spec equals the
reference's for every leaf of the train state (``sgd`` and ``adamw``),
the node-stacked parameters and the decode caches, matched by dotted
path, with the same shapes and dtypes; the inputs' and the serve step's
KV specs too; ``shard_shape`` is ``NamedSharding.shard_shape``; each dry
run record's argument bytes are the sum of the reference's arguments'
shard bytes (less the reference state's PRNG key, which the port's state
does not hold on the device).  Every abstract leaf is a meta tensor.
"""
import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax                                                   # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding         # noqa: E402
from jax.sharding import PartitionSpec as JP                 # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.dlrt import distributed as jdist                  # noqa: E402
from repro.launch import shapes as jshapes                   # noqa: E402
from repro.optim import adamw as jadamw                      # noqa: E402
from repro.optim import sgd as jsgd                          # noqa: E402
from repro_torch.configs import ASSIGNED, get_config         # noqa: E402
from repro_torch.dlrt import distributed as tdist            # noqa: E402
from repro_torch.launch import dryrun, make_production_mesh  # noqa: E402
from repro_torch.launch import shapes as tshapes             # noqa: E402
from repro_torch.launch.mesh import (MeshLayout,             # noqa: E402
                                     make_superstep_mesh)
from repro_torch.optim import adamw, sgd                     # noqa: E402


def _abstract_mesh(sizes, names):
    """AbstractMesh across JAX versions (as ``tests/test_dlrt.py``)."""
    try:
        return AbstractMesh(tuple(sizes), tuple(names))
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


JMESH = {False: _abstract_mesh((16, 16), ("data", "model")),
         True: _abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
MESHES = [False, True]
MESH_IDS = ["single", "multi"]
OPTIMIZERS = {"sgd": (jsgd, sgd), "adamw": (jadamw, adamw)}


def _cases(kinds):
    """(arch, shape) pairs whose shape is one of ``kinds`` and runs."""
    return [(a, s) for a in ASSIGNED for s, spec in tshapes.SHAPES.items()
            if spec.kind in kinds
            and not tshapes.skip_reason(get_config(a), spec)]


def _jkey(path) -> str:
    out = []
    for e in path:
        for attr in ("key", "name", "idx"):
            if hasattr(e, attr):
                out.append(str(getattr(e, attr)))
                break
    return ".".join(out)


def _ref_leaves(tree):
    """{dotted path: leaf} of a reference tree (shardings or shapes)."""
    return {_jkey(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, prefix=""):
    """{dotted path: leaf} of a port tree: dicts by key (a flat dict's
    dotted keys as they are), NamedTuples by field, tuples by index; a
    NamedSharding or a tensor is a leaf, None (the generator's sharding)
    and a generator are none."""
    out = {}
    if isinstance(tree, tdist.NamedSharding) or isinstance(tree,
                                                            torch.Tensor):
        out[prefix[:-1]] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}{k}."))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            out.update(_port_leaves(v, f"{prefix}{f}."))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{prefix}{i}."))
    return out


def _dtype_name(t) -> str:
    return str(t).replace("torch.", "")


def _compare(jshape, jsh, tshape, tsh, mesh, skip=()):
    """Leaf for leaf: the same paths (``skip`` the reference's alone), the
    same shapes and dtypes, the same specs, the same shard shapes; every
    port leaf on meta."""
    jl, jsl = _ref_leaves(jshape), _ref_leaves(jsh)
    tl, tsl = _port_leaves(tshape), _port_leaves(tsh)
    assert sorted(set(jl) - set(skip)) == sorted(tl)
    assert sorted(tl) == sorted(tsl)
    for path, leaf in tl.items():
        want, spec = jl[path], jsl[path]
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(want.shape), path
        assert _dtype_name(leaf.dtype) == str(want.dtype), path
        assert tuple(tsl[path].spec) == tuple(spec.spec), path
        assert tdist.shard_shape(leaf.shape, tsl[path].spec, mesh) == \
            tuple(spec.shard_shape(want.shape)), path


def _shard_bytes(leaf, sharding) -> int:
    return (math.prod(sharding.shard_shape(leaf.shape))
            * np.dtype(leaf.dtype).itemsize)


@functools.lru_cache(maxsize=None)
def _configs(arch, shape, multi_pod):
    jcfg, n, window, jmeta = jshapes.shape_config(
        jget_config(arch), jshapes.SHAPES[shape], multi_pod=multi_pod)
    tcfg, tn, twindow, tmeta = tshapes.shape_config(
        get_config(arch), tshapes.SHAPES[shape], multi_pod=multi_pod)
    assert (n, window, jmeta) == (tn, twindow, tmeta)
    return jcfg, tcfg, n, window


@functools.lru_cache(maxsize=None)
def _ref_train(arch, shape, multi_pod, opt):
    jcfg, _, n, _ = _configs(arch, shape, multi_pod)
    st = jdist.abstract_train_state(jcfg, OPTIMIZERS[opt][0](1e-2), n)
    return st, jdist.train_state_sharding(JMESH[multi_pod], jcfg, st)


@functools.lru_cache(maxsize=None)
def _ref_stacked(arch, n):
    """The reference's abstract population (its shapes do not depend on
    the shape's sliding window, so one per node count)."""
    return jdist.abstract_stacked_params(jget_config(arch), n)


def _ref_params(arch, shape, multi_pod):
    jcfg, _, n, _ = _configs(arch, shape, multi_pod)
    ps = _ref_stacked(arch, n)
    return ps, jdist.params_sharding(JMESH[multi_pod], jcfg, ps)


def _ref_cache(arch, shape, multi_pod):
    jcfg, _, n, window = _configs(arch, shape, multi_pod)
    spec = jshapes.SHAPES[shape]
    cs = jdist.abstract_cache(jcfg, n, spec.global_batch // n,
                              jshapes.cache_len(jcfg, spec, window))
    return cs, jdist.cache_sharding(JMESH[multi_pod], jcfg, cs)


def _ref_inputs(arch, shape, multi_pod):
    """The reference's abstract inputs and their shardings, as its dry run
    lays them out (``repro.launch.dryrun._input_shardings``)."""
    jcfg, _, n, _ = _configs(arch, shape, multi_pod)
    mesh = JMESH[multi_pod]
    specs = jshapes.input_specs(jcfg, jshapes.SHAPES[shape], n)
    base = jdist.batch_sharding(mesh, jcfg, n, specs["tokens"].shape[1])
    sh = {k: (jdist.replicated(mesh) if v.ndim == 0 else NamedSharding(
        mesh, JP(*(tuple(base.spec) + (None,) * (v.ndim - 3)))))
        for k, v in specs.items()}
    return specs, sh


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("multi_pod", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_state_specs_match_the_reference(arch, multi_pod, opt):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for a, shape in _cases(("train",)):
        if a != arch:
            continue
        _, tcfg, n, _ = _configs(arch, shape, multi_pod)
        jst, jsh = _ref_train(arch, shape, multi_pod, opt)
        tst = tdist.abstract_train_state(tcfg, OPTIMIZERS[opt][1](1e-2), n)
        tsh = tdist.train_state_sharding(mesh, tcfg, tst)
        _compare(jst, jsh, tst, tsh, mesh, skip=("morph.key",))


@pytest.mark.parametrize("multi_pod", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_params_cache_and_input_specs_match_the_reference(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for a, shape in _cases(("prefill", "decode")):
        if a != arch:
            continue
        jcfg, tcfg, n, window = _configs(arch, shape, multi_pod)
        jps, jsh = _ref_params(arch, shape, multi_pod)
        tps = tdist.abstract_stacked_params(tcfg, n)
        _compare(jps, jsh, tps, tdist.params_sharding(mesh, tcfg, tps), mesh)
        spec = tshapes.SHAPES[shape]
        b = spec.global_batch // n
        specs = tshapes.input_specs(tcfg, spec, n)
        jspecs, jin = _ref_inputs(arch, shape, multi_pod)
        tin = dryrun.input_shardings(mesh, tcfg, n, specs)
        assert {k: tuple(v.spec) for k, v in tin.items()} == \
            {k: tuple(v.spec) for k, v in jin.items()}
        assert tuple(tdist.batch_sharding(mesh, tcfg, n).spec) == \
            tuple(jdist.batch_sharding(JMESH[multi_pod], jcfg, n).spec)
        if spec.kind != "decode":
            continue
        jcs, jcsh = _ref_cache(arch, shape, multi_pod)
        tcs = tdist.abstract_cache(tcfg, n, b,
                                   tshapes.cache_len(tcfg, spec, window))
        _compare(jcs, jcsh, tcs, tdist.cache_sharding(mesh, tcfg, tcs), mesh)
        assert tuple(tdist.serve_kv_spec(mesh, tcfg, b)) == \
            tuple(jdist.serve_kv_spec(JMESH[multi_pod], jcfg, b))


@pytest.mark.parametrize("multi_pod", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_dryrun_records_match_the_reference(arch, multi_pod):
    """Each record's argument bytes: the reference's abstract arguments'
    shard bytes, summed (its state's key left out); and its other
    columns from the reference's configs and shapes."""
    for shape, spec in tshapes.SHAPES.items():
        rec = dryrun.run_one(arch, shape, multi_pod)
        jcfg0 = jget_config(arch)
        if jshapes.skip_reason(jcfg0, jshapes.SHAPES[shape]):
            assert rec["skipped"] == jshapes.skip_reason(
                jcfg0, jshapes.SHAPES[shape])
            continue
        jcfg, _, n, window = _configs(arch, shape, multi_pod)
        jspecs, jin = _ref_inputs(arch, shape, multi_pod)
        want = sum(_shard_bytes(v, jin[k]) for k, v in jspecs.items())
        if spec.kind == "train":
            st, sh = _ref_train(arch, shape, multi_pod, "sgd")
            leaves, shs = _ref_leaves(st), _ref_leaves(sh)
            want += sum(_shard_bytes(v, shs[p]) for p, v in leaves.items()
                        if p != "morph.key")
        else:
            ps, sh = _ref_params(arch, shape, multi_pod)
            want += sum(_shard_bytes(v, s) for v, s in zip(
                jax.tree_util.tree_leaves(ps), jax.tree_util.tree_leaves(sh)))
            if spec.kind == "decode":
                cs, csh = _ref_cache(arch, shape, multi_pod)
                want += sum(_shard_bytes(v, s) for v, s in zip(
                    jax.tree_util.tree_leaves(cs),
                    jax.tree_util.tree_leaves(csh)))
                assert rec["cache_len"] == jshapes.cache_len(
                    jcfg, jshapes.SHAPES[shape], window)
        assert rec["memory"]["argument_bytes"] == want
        chips = 512 if multi_pod else 256
        tokens = (spec.global_batch if spec.kind == "decode" else
                  spec.global_batch * jshapes.input_specs(
                      jcfg, jshapes.SHAPES[shape], n)["tokens"].shape[-1])
        mult = 6 if spec.kind == "train" else 2
        assert (rec["n_nodes"], rec["policy"], rec["chips"], rec["kind"],
                rec["tokens_per_step"], rec["active_params"],
                rec["total_params"]) == (
            n, jcfg.sharding_policy, chips, spec.kind, tokens,
            jcfg0.active_param_count(), jcfg0.param_count())
        assert rec["model_flops_per_chip"] == \
            mult * jcfg0.active_param_count() * tokens / chips
        assert rec.get("variant") == jshapes.shape_config(
            jcfg0, jshapes.SHAPES[shape], multi_pod=multi_pod)[3].get(
                "variant")


def test_dryrun_cli_writes_every_record(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "whisper-tiny", "--mesh", "both",
                        "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 8
    assert [r["multi_pod"] for r in recs] == [False, True] * 4
    assert sum("skipped" in r for r in recs) == 2       # long_500k
    text = capsys.readouterr().out
    assert text.count("[ OK ]") == 6 and text.count("[SKIP]") == 2


# ---------------------------------------------------------------------------
# tests/test_dlrt.py's spec cases, against the port.
# ---------------------------------------------------------------------------

MESH1 = make_production_mesh()
MESH2 = make_production_mesh(multi_pod=True)


def _spec(shape, policy, mesh=MESH1, periods=9, names=()):
    return tuple(tdist.leaf_spec(".".join(names), shape, policy=policy,
                                 mesh=mesh, num_periods=periods,
                                 n_nodes=shape[0]))


def test_node_dp_specs():
    assert _spec((16, 9, 512, 2048), "node_dp") == \
        ("data", None, None, "model")
    assert _spec((16, 9, 512), "node_dp") == ("data", None, "model")
    assert _spec((16, 102400, 2048), "node_dp", periods=28) == \
        ("data", None, "model")
    assert _spec((16, 9, 2048), "node_dp") == ("data", None, "model")


def test_node_dp_multipod_uses_both_axes():
    assert _spec((32, 9, 512, 2048), "node_dp", mesh=MESH2)[0] == \
        ("pod", "data")


def test_expert_banks_get_expert_parallelism():
    sp = _spec((16, 27, 64, 2048, 1408), "node_dp", periods=27,
               names=("body", "0", "mlp", "up"))
    assert sp[2] == "model"


def test_node_fsdp_two_axes():
    assert _spec((2, 9, 8192, 24576), "node_fsdp") == \
        (None, None, "data", "model")
    assert _spec((2, 9, 8192, 24576), "node_fsdp", mesh=MESH2)[0] == "pod"


def test_period_axis_never_sharded():
    assert _spec((2, 16, 8192, 24576), "node_fsdp", periods=16)[1] is None


def test_cache_spec_kv():
    sp = tuple(tdist.cache_spec("", (16, 28, 8, 32768, 8, 128),
                                policy="node_dp", mesh=MESH1,
                                num_periods=28))
    assert sp[0] == "data" and sp[-1] == "model"
    assert sp[3] is None


def test_serve_kv_spec_matches_cache_spec():
    assert tuple(tdist.serve_kv_spec(
        MESH1, get_config("nemotron-4-340b"), 64)) == \
        ("data", None, None, "model")
    assert tuple(tdist.serve_kv_spec(
        MESH1, get_config("llama3.2-3b"), 8)) == (None, None, None, "model")


# ---------------------------------------------------------------------------
# The mesh layout, shard shapes and placements.
# ---------------------------------------------------------------------------

def test_production_mesh_layout():
    assert dict(MESH1.shape) == {"data": 16, "model": 16}
    assert dict(MESH2.shape) == {"pod": 2, "data": 16, "model": 16}
    assert MESH2.axis_names == ("pod", "data", "model")
    assert (MESH1.size, MESH2.size) == (256, 512)
    assert tdist.node_axes(MESH1) == ("data",)
    assert tdist.node_axes(MESH2) == ("pod", "data")
    for multi, jmesh in JMESH.items():
        layout = make_production_mesh(multi_pod=multi)
        assert dict(layout.shape) == dict(jmesh.shape)
        assert layout.axis_names == tuple(jmesh.axis_names)


def test_device_mesh_needs_the_mesh_s_ranks():
    """Without a process group of 256 (512) ranks the real DeviceMesh
    is refused, naming the ranks needed; a one-rank layout over a
    one-rank gloo group is made, and a DTensor laid out by
    :func:`placements` holds :func:`shard_shape` on its rank."""
    for layout, ranks in ((MESH1, 256), (MESH2, 512)):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
            layout.device_mesh("cpu")
    from torch.distributed.tensor import distribute_tensor
    node = make_superstep_mesh(1, device="cpu")
    try:
        one = MeshLayout(("data", "model"), (1, 1))
        dm = one.device_mesh("cpu")
        assert dm.mesh_dim_names == ("data", "model")
        spec = tdist.P("data", None, "model")
        dt = distribute_tensor(torch.ones(4, 3, 8), dm,
                               tdist.placements(spec, one))
        assert tuple(dt.to_local().shape) == \
            tdist.shard_shape((4, 3, 8), spec, one)
        with pytest.raises(ValueError, match="needs 256 ranks"):
            MESH1.device_mesh("cpu")
    finally:
        node.close()


def test_shard_shape_and_placements():
    spec = tdist.P(("pod", "data"), None, "model")
    assert tdist.shard_shape((32, 9, 512), spec, MESH2) == (1, 9, 32)
    assert tdist.shard_shape((32, 9, 512), tdist.P(), MESH2) == (32, 9, 512)
    with pytest.raises(ValueError, match="does not divide"):
        tdist.shard_shape((24, 9, 512), spec, MESH2)
    from torch.distributed.tensor import Replicate, Shard
    assert tdist.placements(spec, MESH2) == (Shard(0), Shard(0), Shard(2))
    assert tdist.placements(tdist.P(None, "data"), MESH1) == \
        (Shard(1), Replicate())
    assert tdist.placements(tdist.P(), MESH1) == (Replicate(), Replicate())
    sh = tdist.replicated(MESH1)
    assert tuple(sh.spec) == ()
    assert tdist.placements(sh.spec, MESH1) == (Replicate(),) * 2


def test_abstract_helpers_allocate_nothing():
    """Every abstract leaf of every architecture is a meta tensor, and
    building them draws nothing (the CPU's default generator and the
    card's memory untouched)."""
    before = torch.random.get_rng_state()
    for arch in ASSIGNED:
        cfg = get_config(arch)
        state = tdist.abstract_train_state(cfg, adamw(1e-3), 4)
        trees = (state.params, state.opt_state, state.morph[:4],
                 tdist.abstract_stacked_params(cfg, 2),
                 tdist.abstract_cache(cfg, 2, 2, 64))
        for tree in trees:
            leaves = _port_leaves(tree)
            assert leaves and all(v.device.type == "meta"
                                  for v in leaves.values()), arch
    assert torch.equal(torch.random.get_rng_state(), before)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_meta_init_matches_the_cpu_init(arch):
    """``init_params`` and ``init_cache`` on the meta device (one period
    made, no draws) give the CPU's tree, shapes and dtypes, at the
    reduced config with two periods."""
    from repro_torch.models import model
    from repro_torch.tree import flatten
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, num_layers=2 * cfg.num_layers
                              - len(cfg.prefix))
    assert cfg.num_periods == 2
    for make in (lambda dev: model.init_params(cfg, 3, dev),
                 lambda dev: model.init_cache(cfg, 2, 8, device=dev)):
        meta, cpu = flatten(make("meta")), flatten(make("cpu"))
        assert list(meta) == list(cpu)
        for k, v in cpu.items():
            assert meta[k].is_meta, k
            assert (meta[k].shape, meta[k].dtype) == (v.shape, v.dtype), k


def test_initialisers_draw_only_off_the_meta_device():
    """``layers.drawn`` is where every initialiser decides whether to draw:
    on the meta device its draw is never called; elsewhere a leaf is the
    f32 draw cast to its dtype, as ``_trunc_normal`` and ``normal`` drew
    before the decision moved there."""
    from repro_torch.models import layers
    meta = layers.generator(torch.device("meta"), 0)
    calls = []
    leaf = layers.drawn(meta, (3, 5), torch.bfloat16,
                        lambda: calls.append(1))
    assert calls == [] and leaf.is_meta
    assert (tuple(leaf.shape), leaf.dtype) == ((3, 5), torch.bfloat16)
    gen = layers.generator(torch.device("cpu"), 7)
    ref = torch.Generator().manual_seed(7)
    got = layers._trunc_normal(gen, (64, 8), 0.5, torch.bfloat16)
    w = torch.empty((64, 8))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=ref)
    assert torch.equal(got, w.mul_(0.5).to(torch.bfloat16))
    got = layers.normal(gen, (16, 4), 0.02, torch.bfloat16)
    want = torch.randn((16, 4), generator=ref).mul_(0.02)
    assert torch.equal(got, want.to(torch.bfloat16))
