"""Phi-4-mini 3.8B [arXiv:2412.08905].

Dense decoder: 32 layers, d_model 3072, 24 heads GQA (8 KV), SwiGLU
d_ff 8192, 200k vocab, RoPE.
A copy of ``repro.configs.phi4_mini``, registered under the same name.
"""
from .base import ArchConfig, register


@register("phi4-mini-3.8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        citation="arXiv:2412.08905 (Phi-4)",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=10_000.0,
        tie_embeddings=True,
        sharding_policy="node_dp",
        n_nodes=16,
    )
