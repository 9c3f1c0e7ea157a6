"""Gossip payload codecs: int8 / fp8-e4m3 quantization, top-k
sparsification, error feedback — the port of ``repro.compress.codec``.

Every codec works row-wise on flat ``[rows, D]`` f32 tensors, one row per
node's payload, so any row subset decodes on its own.

**Exactness.** With payload ``b`` (f32) and ``d = decode(encode(b))``,
the residual ``e' = b - d`` and the reconstruction ``d + e'`` are exact in
f32: a quantizer leaves ``|b - d| <= step/2`` with ``|d| >= step`` or
``d == 0`` per coordinate (Sterbenz), and top-k sends a kept coordinate
verbatim and leaves a dropped one whole in the residual (disjoint
supports).  The reference notes that XLA's CPU flushes f32 subnormals to
zero; PyTorch's CPU and the card keep them, so the two agree bit for bit
over the normal range (``|x| = 0`` or ``>= 2**-126``).

The bits of each step follow the reference: top-k ties go to the lower
index (:func:`repro_torch.core.selection.stable_topk`, as
``jax.lax.top_k``), the scale and the quantizers divide (no reciprocal
product), int8 rounds half to even and clips before the cast, and fp8
casts ``vals / scale`` with round-to-nearest-even, so ``448 (1 + eps)``
becomes 448.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from ..core.selection import stable_topk

INT8_MAX = 127.0
# Largest finite float8_e4m3fn value.
FP8_MAX = 448.0
QUANT_KINDS = ("none", "int8", "fp8")
DEFAULT_TOPK_FRAC = 0.25
# Widest leaf a 16-bit top-k index can address; wider leaves use int32
# indices (the tensors and the byte accounting alike).
INT16_MAX_D = 32767


@dataclass(frozen=True)
class CompressConfig:
    """Parsed form of the ``compress=`` knob.

    ``quant`` picks the value codec (``"none"`` | ``"int8"`` | ``"fp8"``),
    ``topk_frac`` keeps only that fraction of each row's largest-magnitude
    coordinates (None = dense), ``error_feedback`` carries the coding
    error into the next round's payload, ``sim`` routes the Eq.-3
    similarity and the sparse controller through the decoded replicas
    instead of the raw parameters, and ``gamma`` is the consensus step
    size (CHOCO-SGD's γ; None resolves through :attr:`consensus_gamma`).
    """
    quant: str = "none"
    topk_frac: Optional[float] = None
    error_feedback: bool = True
    sim: bool = True
    gamma: Optional[float] = None

    def __post_init__(self):
        if self.quant not in QUANT_KINDS:
            raise ValueError(f"quant={self.quant!r} not in {QUANT_KINDS}")
        if self.topk_frac is not None \
                and not 0.0 < float(self.topk_frac) <= 1.0:
            raise ValueError("topk_frac must be in (0, 1], got "
                             f"{self.topk_frac!r}")
        if self.gamma is not None and not 0.0 < float(self.gamma) <= 1.0:
            raise ValueError(f"gamma must be in (0, 1], got "
                             f"{self.gamma!r}")

    @property
    def consensus_gamma(self) -> float:
        """The consensus step size the engines apply: ``gamma`` when set,
        else 1 for dense codecs and ``min(1, 2 topk_frac)`` under top-k
        (full steps through replicas that lag by the dropped share of
        every delta under-mix, then over-correct)."""
        if self.gamma is not None:
            return float(self.gamma)
        if self.topk_frac is None:
            return 1.0
        return min(1.0, 2.0 * float(self.topk_frac))

    @property
    def enabled(self) -> bool:
        """False for the identity codec, which the engines treat exactly
        as ``compress="none"``."""
        return self.quant != "none" or self.topk_frac is not None

    def spec(self) -> str:
        """Canonical string form (inverse of :meth:`parse`)."""
        parts = [] if self.quant == "none" else [self.quant]
        if self.topk_frac is not None:
            parts.append(f"topk{self.topk_frac:g}")
        if self.gamma is not None:
            parts.append(f"gamma{self.gamma:g}")
        return "+".join(parts) or "none"

    @classmethod
    def parse(cls, spec) -> "CompressConfig":
        """``"none"`` | ``"int8"`` | ``"fp8"`` | ``"topk[frac]"`` |
        ``"gamma[step]"`` and ``"+"``-joined combinations
        (``"int8+topk0.25"``); a :class:`CompressConfig` passes through.
        ``"auto"`` is refused: :func:`repro_torch.tune.resolve_knobs`
        resolves it before the codec is built."""
        if isinstance(spec, cls):
            return spec
        if spec is None:
            return cls()
        if not isinstance(spec, str):
            raise TypeError("compress accepts a spec string or a "
                            f"CompressConfig, got {type(spec).__name__}")
        if spec == "auto":
            raise TypeError('compress="auto" is resolved by repro_torch.'
                            "tune.resolve_knobs before the codec is built")
        quant, frac, gamma = "none", None, None
        for term in spec.split("+"):
            term = term.strip()
            if term in ("", "none"):
                continue
            if term in ("int8", "fp8"):
                if quant != "none":
                    raise ValueError(f"duplicate quantizer in {spec!r}")
                quant = term
            elif term.startswith("topk"):
                if frac is not None:
                    raise ValueError(f"duplicate top-k in {spec!r}")
                tail = term[len("topk"):]
                frac = float(tail) if tail else DEFAULT_TOPK_FRAC
            elif term.startswith("gamma"):
                if gamma is not None:
                    raise ValueError(f"duplicate gamma in {spec!r}")
                gamma = float(term[len("gamma"):])
            else:
                raise ValueError(
                    f"unknown compress term {term!r} in {spec!r}; valid: "
                    "none, int8, fp8, topk[frac], gamma[step]")
        return cls(quant=quant, topk_frac=frac, gamma=gamma)


def topk_k(d: int, frac: float) -> int:
    """Per-leaf keep count: at least one coordinate, at most all."""
    return max(1, min(d, int(round(frac * d))))


def _idx_dtype(d: int) -> torch.dtype:
    return torch.int16 if d <= INT16_MAX_D else torch.int32


def encode_leaf(x2d: torch.Tensor, cfg: CompressConfig
                ) -> Dict[str, torch.Tensor]:
    """Encode one flat ``[rows, d]`` payload into its wire tensors: ``v``
    f32 values (no quantizer), ``q`` int8 / float8_e4m3fn codes and
    ``scale`` the f32 row scale ``max|x| / qmax`` (quantizer on), ``idx``
    int16 / int32 kept coordinates (top-k on).  A zero row encodes to zero
    codes with scale 0 and decodes to exact zeros."""
    x2d = x2d.float()
    d = x2d.shape[1]
    wire: Dict[str, torch.Tensor] = {}
    vals = x2d
    if cfg.topk_frac is not None:
        _, idx = stable_topk(x2d.abs(), topk_k(d, cfg.topk_frac))
        vals = x2d.gather(1, idx)
        wire["idx"] = idx.to(_idx_dtype(d))
    if cfg.quant != "none":
        qmax = torch.tensor(INT8_MAX if cfg.quant == "int8" else FP8_MAX,
                            device=vals.device)
        # Top-k keeps the largest |x|, so the scale is the same with it.
        # qmax is a tensor on the rows' device: given a host number, CUDA
        # multiplies by its reciprocal instead of dividing.
        scale = vals.abs().amax(dim=1) / qmax
        safe = torch.where(scale > 0, scale, 1.0)[:, None]
        if cfg.quant == "int8":
            q = torch.round(vals / safe).clamp(-INT8_MAX, INT8_MAX) \
                .to(torch.int8)
        else:
            q = (vals / safe).to(torch.float8_e4m3fn)
        wire["q"] = q
        wire["scale"] = scale
    else:
        wire["v"] = vals
    return wire


def decode_leaf(wire: Mapping[str, torch.Tensor], d: int,
                cfg: CompressConfig) -> torch.Tensor:
    """Wire tensors back to a dense f32 ``[rows, d]`` payload, row by
    row."""
    if cfg.quant != "none":
        vals = wire["q"].float() * wire["scale"][:, None]
    else:
        vals = wire["v"]
    if cfg.topk_frac is None:
        return vals
    out = torch.zeros((vals.shape[0], d), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_(1, wire["idx"].long(), vals)


def roundtrip_leaf(x2d: torch.Tensor, cfg: CompressConfig) -> torch.Tensor:
    """``decode(encode(x))``."""
    x2d = x2d.float()
    return decode_leaf(encode_leaf(x2d, cfg), x2d.shape[1], cfg)


def _flat2d(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.reshape(leaf.shape[0], -1)


def zero_residual(tree: Mapping[str, torch.Tensor]
                  ) -> "OrderedDict[str, torch.Tensor]":
    """Fresh error-feedback state: f32 zeros in every leaf's shape."""
    return OrderedDict((k, torch.zeros(v.shape, dtype=torch.float32,
                                       device=v.device))
                       for k, v in tree.items())


def payload_rows(leaf: torch.Tensor, resid: torch.Tensor,
                 cfg: CompressConfig) -> torch.Tensor:
    """One leaf's flat f32 ``[rows, d]`` payload: the leaf plus its
    residual under error feedback, the leaf alone without."""
    b = _flat2d(leaf).float()
    return b + _flat2d(resid) if cfg.error_feedback else b


def next_residual(b: torch.Tensor, dec: torch.Tensor,
                  wire: Mapping[str, torch.Tensor], resid: torch.Tensor,
                  cfg: CompressConfig, delta: bool) -> torch.Tensor:
    """The flat residual after sending payload ``b`` decoded as ``dec``:
    ``b - dec``; under difference coding (``delta``) with top-k, only on
    the sent coordinates; ``resid`` itself without error feedback."""
    if not cfg.error_feedback:
        return _flat2d(resid)
    if not delta or cfg.topk_frac is None:
        return b - dec
    sent = torch.zeros(b.shape, dtype=torch.bool, device=b.device)
    sent.scatter_(1, wire["idx"].long(), True)
    return torch.where(sent, b - dec, 0.0)


def _payload(tree, resid, cfg: CompressConfig, delta: bool):
    wire, dec, new_r = OrderedDict(), OrderedDict(), OrderedDict()
    for k, leaf in tree.items():
        b = payload_rows(leaf, resid[k], cfg)
        w = encode_leaf(b, cfg)
        dc = decode_leaf(w, b.shape[1], cfg)
        e = next_residual(b, dc, w, resid[k], cfg, delta)
        wire[k] = w
        dec[k] = dc.reshape(leaf.shape)
        new_r[k] = e.reshape(leaf.shape)
    return wire, dec, new_r


def encode_payload(tree: Mapping[str, torch.Tensor],
                   resid: Mapping[str, torch.Tensor], cfg: CompressConfig):
    """One error-feedback step over node-stacked leaves: per leaf (f32)
    payload ``b = params + resid``, wire ``encode(b)``, decoded ``d =
    decode(wire)``, residual ``b - d``.  Returns ``(wire, decoded,
    resid)`` dicts; ``decoded`` leaves are f32 in the leaf shapes.  With
    ``error_feedback=False`` the payload is the raw leaf and the residual
    is handed back unchanged."""
    return _payload(tree, resid, cfg, delta=False)


def encode_delta_payload(tree: Mapping[str, torch.Tensor],
                         resid: Mapping[str, torch.Tensor],
                         cfg: CompressConfig):
    """The engines' difference-coded step: ``tree`` is the replica delta
    ``params - hat``.  As :func:`encode_payload`, except that a top-k
    coordinate that was not sent keeps no residual: it stays in the
    replica gap and is in next round's delta whole, so feeding it back as
    well would count it twice.  The residual carries only the sent
    coordinates' quantization error; without top-k this is
    :func:`encode_payload`."""
    return _payload(tree, resid, cfg, delta=True)


def decode_wire_tree(wire_tree: Mapping[str, Mapping[str, torch.Tensor]],
                     template_tree: Mapping[str, torch.Tensor],
                     cfg: CompressConfig) -> "OrderedDict[str, torch.Tensor]":
    """Decode a dict of wire dicts to f32 leaves shaped like
    ``template_tree``'s trailing dims (the row count comes from the
    wire)."""
    out = OrderedDict()
    for k, t in template_tree.items():
        dec = decode_leaf(wire_tree[k], _flat2d(t).shape[1], cfg)
        out[k] = dec.reshape((dec.shape[0],) + tuple(t.shape[1:]))
    return out


def leaf_wire_bytes(d: int, cfg: CompressConfig,
                    dense_value_bytes: int = 4) -> int:
    """Analytic per-node wire bytes of one leaf of ``d`` features: codes
    (1 byte) or f32 values for the kept coordinates, a 4-byte scale with a
    quantizer, and the top-k support at the cheaper of an index list (2 or
    4 bytes a kept coordinate) and a position bitmap (``ceil(d / 8)``)."""
    if not cfg.enabled:
        return dense_value_bytes * d
    k = d if cfg.topk_frac is None else topk_k(d, cfg.topk_frac)
    value_bytes = 4 if cfg.quant == "none" else 1
    idx_total = 0
    if cfg.topk_frac is not None:
        idx_elt = 2 if d <= INT16_MAX_D else 4
        idx_total = min(k * idx_elt, -(-d // 8))
    scale_bytes = 0 if cfg.quant == "none" else 4
    return k * value_bytes + idx_total + scale_bytes


def wire_bytes_tree(params: Mapping[str, torch.Tensor], n_nodes: int,
                    cfg: CompressConfig) -> int:
    """Per-transfer wire bytes of one node's slice of node-stacked
    parameters (the compressed counterpart of
    :func:`repro_torch.dlrt.stacked_model_bytes`)."""
    return sum(leaf_wire_bytes(v.numel() // n_nodes, cfg)
               for v in params.values())
