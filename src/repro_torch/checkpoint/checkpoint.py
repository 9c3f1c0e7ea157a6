"""Pytree checkpoints in the reference's file format: the port of
``repro.checkpoint.checkpoint``.

A file is a MessagePack map (:mod:`.msgpack`, byte for byte what
``msgpack.packb`` writes), compressed with zstd at level 3 when the
``zstandard`` module imports and with zlib otherwise; loading reads either
by its magic bytes.  A leaf is stored as ``{"__nd__": True, "dtype", "shape",
"data"}`` with numpy's dtype name and the raw C-order bytes (bfloat16 as
its uint16 bits under the name ``"bfloat16"``), a list or tuple as
``{"__seq__": "list" | "tuple", "items"}``, a Python scalar or None as
``{"__py__": value}``; dicts stay maps, their keys sorted at every level as
``jax.device_get`` hands the reference its tree.  So for the same tree the
port writes the reference's bytes, and each package reads the other's
files.  A leaf is at most 2^32 - 1 bytes (MessagePack's bin32), in both.

Writes are atomic: the file is written beside its name with ``.tmp``
appended, then renamed over it.
"""
from __future__ import annotations

import os
import re
import zlib
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from . import msgpack

try:
    import zstandard
except ImportError:                      # optional: fall back to zlib
    zstandard = None

_BF16 = "bfloat16"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def compressor() -> str:
    """The compressor a save uses here: ``"zstd"`` or ``"zlib"``."""
    return "zstd" if zstandard is not None else "zlib"


def _compress(payload: bytes, level: int) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=level).compress(payload)
    return zlib.compress(payload, min(level, 9))   # zstd levels reach 22


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "zstandard module is not installed")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).cpu().numpy().view(np.uint16)
            return {"__nd__": True, "dtype": _BF16,
                    "shape": list(raw.shape), "data": raw.tobytes()}
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(x)
    return {"__nd__": True, "dtype": str(arr.dtype),
            "shape": list(arr.shape), "data": arr.tobytes()}


def _unpack_leaf(d: dict, device: torch.device) -> torch.Tensor:
    shape = tuple(d["shape"])
    if d["dtype"] == _BF16:
        raw = np.frombuffer(d["data"], np.int16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16).to(device)
    arr = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def _encode(obj) -> Any:
    if isinstance(obj, dict):
        return {k: _encode(obj[k]) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": type(obj).__name__,
                "items": [_encode(v) for v in obj]}
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        return _pack_leaf(obj)
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return {"__py__": obj}
    raise TypeError(f"cannot checkpoint {type(obj)}")


def _decode(obj, device: torch.device):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return _unpack_leaf(obj, device)
        if "__seq__" in obj:
            items = [_decode(v, device) for v in obj["items"]]
            return tuple(items) if obj["__seq__"] == "tuple" else items
        if "__py__" in obj:
            return obj["__py__"]
        return {k: _decode(v, device) for k, v in obj.items()}
    return obj


def save_pytree(path: str, tree, level: int = 3) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors on any
    device, numpy arrays and Python scalars) to ``path``."""
    payload = msgpack.packb(_encode(tree))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_compress(payload, level))
    os.replace(tmp, path)


def load_pytree(path: str, device="cuda"):
    """The tree in ``path``, its arrays as tensors on ``device`` (the card
    unless the caller asks for the CPU; bfloat16 as ``torch.bfloat16``),
    its Python scalars as they were saved."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = _decompress(f.read())
    return _decode(msgpack.unpackb(payload), dev)


class CheckpointManager:
    """Step-indexed checkpoints ``ckpt_{step:08d}.msgpack.zst`` in
    ``directory``, the newest ``keep`` retained."""

    _PAT = re.compile(r"ckpt_(\d+)\.msgpack\.zst$")

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.msgpack.zst")

    def steps(self):
        out = []
        for f in os.listdir(self.dir):
            m = self._PAT.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, tree) -> str:
        path = self._path(step)
        save_pytree(path, tree)
        for old in self.steps()[:-self.keep]:
            os.remove(self._path(old))
        return path

    def restore(self, step: Optional[int] = None, device="cuda"):
        """``(step, tree)`` of checkpoint ``step``, the newest if None,
        loaded onto ``device``."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        return step, load_pytree(self._path(step), device)
