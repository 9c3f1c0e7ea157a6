"""Compressed gossip: quantized and top-k model exchange with error
feedback — the port of ``repro.compress``.

:class:`CompressConfig` is the ``compress=`` knob's parsed form (``"int8"``,
``"fp8"``, ``"topk0.25"``, ``"int8+topk0.75+gamma0.5"``);
:func:`encode_delta_payload` is the engines' difference-coded
error-feedback step and :func:`wire_bytes_tree` the analytic bytes a
transfer costs, which the engines charge in place of the dense f32
payload.  The codec runs as PyTorch tensor operations on the card and on
the CPU alike: the reference has no kernel for it either.
"""
from .codec import (DEFAULT_TOPK_FRAC, FP8_MAX, INT8_MAX, INT16_MAX_D,
                    QUANT_KINDS, CompressConfig, decode_leaf,
                    decode_wire_tree, encode_delta_payload, encode_leaf,
                    encode_payload, leaf_wire_bytes, next_residual,
                    payload_rows, roundtrip_leaf, topk_k, wire_bytes_tree,
                    zero_residual)

__all__ = ["DEFAULT_TOPK_FRAC", "FP8_MAX", "INT8_MAX", "INT16_MAX_D",
           "QUANT_KINDS", "CompressConfig", "decode_leaf",
           "decode_wire_tree", "encode_delta_payload", "encode_leaf",
           "encode_payload", "leaf_wire_bytes", "next_residual",
           "payload_rows", "roundtrip_leaf", "topk_k", "wire_bytes_tree",
           "zero_residual"]
