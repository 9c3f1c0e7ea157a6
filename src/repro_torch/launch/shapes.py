"""The four assigned input shapes and each model input's shape and dtype:
the port of ``repro.launch.shapes``.

=============  =========  ============  =========================
shape          seq_len    global_batch  step
=============  =========  ============  =========================
train_4k           4,096           256  train_step (Alg. 2 superstep)
prefill_32k       32,768            32  prefill (forward, last logits)
decode_32k        32,768           128  serve_step (1 token, 32k cache)
long_500k        524,288             1  serve_step (1 token, 500k ctx)
=============  =========  ============  =========================

Per-arch adaptations, as in the reference:
  * whisper-tiny caps decoder positions at 448 (its spec): train and
    prefill take 448 decoder tokens and the 1,500-frame encoder;
    ``long_500k`` is skipped.
  * ``long_500k`` needs sub-quadratic attention: native for rwkv6 and
    jamba; dense archs run the sliding-window variant (window 8192, ring
    KV cache); serving takes one node (one global request).
  * VLM archs give ``frontend_tokens`` of the sequence to stub patch
    embeddings (precomputed, 1024 wide).

Where the reference returns ``jax.ShapeDtypeStruct`` stand-ins,
:func:`input_specs` returns :class:`TensorSpec` ``(shape, torch.dtype)``
pairs, which allocate nothing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.transformer import VISION_DIM

SLIDING_WINDOW_500K = 8192


class TensorSpec(NamedTuple):
    """A model input's shape and dtype (the reference's
    ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# Per-node microbatch for train_4k's gradient accumulation (None = the
# whole per-node batch in one piece).
TRAIN_MICROBATCH = {
    "jamba-1.5-large-398b": 8,
    "qwen1.5-110b": 16,
    "nemotron-4-340b": 4,
    "llama4-scout-17b-a16e": 16,
    "pixtral-12b": 8,
    "rwkv6-7b": 8,
    "deepseek-moe-16b": 8,
    "llama3.2-3b": 8,
    "phi4-mini-3.8b": 8,
    "whisper-tiny": None,
}


def skip_reason(cfg, shape: ShapeSpec) -> Optional[str]:
    """Why ``cfg`` does not run ``shape``, or None."""
    if shape.name == "long_500k" and cfg.encoder is not None:
        return ("enc-dec with 448 decoder positions by spec; a 500k causal "
                "decode is architecturally meaningless (DESIGN.md §4)")
    return None


def _is_subquadratic(cfg) -> bool:
    return cfg.family in ("ssm", "hybrid")


def shape_config(cfg, shape: ShapeSpec, *, multi_pod: bool = False):
    """The arch config adapted to the input shape, and the serving node
    count.  Returns (cfg, n_nodes, window, meta)."""
    window: Any = "cfg"
    meta: Dict[str, Any] = {}
    n_nodes = cfg.n_nodes
    if multi_pod and cfg.sharding_policy == "node_dp":
        n_nodes = cfg.n_nodes * 2        # 32 DL nodes over 2 pods
    if shape.name == "long_500k":
        n_nodes = 1                      # one global long-context request
        if not _is_subquadratic(cfg):
            cfg = dataclasses.replace(cfg,
                                      sliding_window=SLIDING_WINDOW_500K)
            window = SLIDING_WINDOW_500K
            meta["variant"] = f"sliding-window {SLIDING_WINDOW_500K} " \
                              "(beyond-paper long-context variant)"
        else:
            meta["variant"] = "native sub-quadratic decode"
    if shape.global_batch % n_nodes != 0:
        # the largest node count (halving) that divides the batch
        while shape.global_batch % n_nodes != 0:
            n_nodes //= 2
        n_nodes = max(n_nodes, 1)
    return cfg, n_nodes, window, meta


def _dec_len(cfg, seq_len: int) -> int:
    """Decoder text length for train and prefill (Whisper caps it at its
    positions; a VLM leaves ``frontend_tokens`` to its patches)."""
    if cfg.encoder is not None:
        return min(seq_len, cfg.max_position)
    if cfg.frontend is not None:
        return seq_len - cfg.frontend_tokens
    return seq_len


def input_specs(cfg, shape: ShapeSpec, n_nodes: int
                ) -> Dict[str, TensorSpec]:
    """Every model input's node-stacked shape and dtype: ``tokens`` (and
    for training ``labels``) ``[n, b, s]`` int32, Whisper's ``frames``
    ``[n, b, 1500, d_model]`` f32, a VLM's ``patch_embeds`` ``[n, b,
    frontend_tokens, 1024]`` f32; for decode one token ``[n, b, 1]`` and
    the scalar ``pos``."""
    b = shape.global_batch // n_nodes
    if shape.kind in ("train", "prefill"):
        s = _dec_len(cfg, shape.seq_len)
        specs = {"tokens": TensorSpec((n_nodes, b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = TensorSpec((n_nodes, b, s), torch.int32)
        if cfg.encoder is not None:
            specs["frames"] = TensorSpec(
                (n_nodes, b, cfg.encoder.seq_len, cfg.d_model),
                torch.float32)
        elif cfg.frontend == "vision":
            specs["patch_embeds"] = TensorSpec(
                (n_nodes, b, cfg.frontend_tokens, VISION_DIM),
                torch.float32)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"tokens": TensorSpec((n_nodes, b, 1), torch.int32),
            "pos": TensorSpec((), torch.int32)}


def frontend_inputs(cfg, lead, gen: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
    """The stub frontend's input for a batch of leading shape ``lead``,
    standard normal drawn from ``gen`` on its device at the shape and
    dtype :func:`input_specs` gives it: Whisper's ``frames [*lead, T,
    d_model]`` or a VLM's ``patch_embeds [*lead, frontend_tokens,
    1024]`` (none for a text-only model)."""
    specs = input_specs(cfg, SHAPES["train_4k"], 1)
    return {k: torch.randn(tuple(lead) + v.shape[2:], generator=gen,
                           dtype=v.dtype, device=gen.device)
            for k, v in specs.items() if k in ("frames", "patch_embeds")}


def cache_len(cfg, shape: ShapeSpec, window) -> int:
    """KV buffer length for decode shapes: a ring of ``window`` slots for
    windowed archs, else the full context (Whisper's 32k self-attention
    cache runs past its 448-position spec, as in the reference)."""
    if isinstance(window, int):
        return window
    return shape.seq_len
