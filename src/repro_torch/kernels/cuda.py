"""Build, load and call the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root (named by a hash of the
source and flags, so an edited source is rebuilt) and loaded with
``ctypes``.  :func:`build_all` compiles several sources at once, one
``nvcc`` process each.  Nothing here runs at import time, so hosts without
``nvcc`` or a card import the kernel modules freely; only a call with a
CUDA tensor reaches this module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from functools import lru_cache
from typing import Callable, Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pairwise_cosine", "graph_mix", "graph_mix_sparse",
           "selective_scan", "selective_scan_bwd")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], Callable] = {}
_counters: Dict[Tuple[torch.device, str], torch.Tensor] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to (named by a hash of it, the
    shared headers ``csrc/*.cuh`` and the flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source in ``names`` that is not built yet, all
    ``nvcc`` processes at once; returns per-source ``{"seconds", "log"}``
    (the ``-Xptxas=-v`` register and shared-memory report).  Raises with
    the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, target)            # atomic: no half-written .so
        (BUILD_DIR / f"{name}.log").write_text(log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library (built on first use), with
    ``argtypes`` declared for every function in ``signatures`` and an
    ``int`` (``cudaError_t``) result."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def function(name: str, fn: str, signatures: Dict[str, list]) -> Callable:
    """The C function ``fn`` of ``csrc/<name>.cu`` (see :func:`library`),
    resolved once per loaded library."""
    got = _functions.get((name, fn))
    if got is None:
        lib = library(name, signatures)
        got = getattr(lib, fn)
        if _loaded.get(name) is lib:
            _functions[name, fn] = got
    return got


def check(lib: ctypes.CDLL, name: str, status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = getattr(lib, f"{name}_error_string")(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors on ``device`` (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def counters(device: torch.device, key: str, count: int) -> torch.Tensor:
    """At least ``count`` zeroed int32 counters on ``device`` for the
    kernel ``key``, kept from call to call: a kernel that takes them leaves
    them zeroed again, so calls that share them must run one after another
    (on one stream)."""
    buf = _counters.get((device, key))
    if buf is None or buf.numel() < count:
        buf = _counters[device, key] = torch.zeros(
            max(count, 1024), dtype=torch.int32, device=device)
    return buf


def require(what: str, *tensors: torch.Tensor, dtypes=None) -> None:
    """Refuse what the kernels do not take: a tensor off the card, on
    another card than the first, of another dtype, or not contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: needs CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous tensors")
    if dtypes is not None and tensors[-1].dtype not in dtypes:
        raise ValueError(f"{what}: dtype {tensors[-1].dtype} not in "
                         f"{dtypes}")
