"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B; family hf:meta-llama/Llama-3.2-1B].

Dense decoder: 28 layers, d_model 3072, 24 heads GQA (8 KV), SwiGLU
d_ff 8192, vocab 128256, RoPE theta 500k, tied embeddings.
A copy of ``repro.configs.llama3_2_3b``, registered under the same name.
"""
from .base import ArchConfig, register


@register("llama3.2-3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b",
        family="dense",
        citation="hf:meta-llama/Llama-3.2-3B (small llama3)",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=500_000.0,
        tie_embeddings=True,
        sharding_policy="node_dp",
        n_nodes=16,
    )
