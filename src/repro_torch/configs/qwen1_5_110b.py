"""Qwen1.5-110B [hf:Qwen/Qwen1.5-110B; family card hf:Qwen/Qwen1.5-0.5B].

Dense decoder: 80 layers, d_model 8192, 64 heads with GQA (8 KV heads),
SwiGLU d_ff 49152, vocab 152064.  Distinguishing feature: **QKV bias**.
A copy of ``repro.configs.qwen1_5_110b``, registered under the same name.
"""
from .base import ArchConfig, register


@register("qwen1.5-110b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b",
        family="dense",
        citation="hf:Qwen/Qwen1.5-110B (QKV bias per hf:Qwen/Qwen1.5-0.5B)",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        sharding_policy="node_fsdp",
        n_nodes=2,
    )
