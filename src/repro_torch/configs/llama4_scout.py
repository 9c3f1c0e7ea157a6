"""Llama-4-Scout 17B-active/16E [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE decoder with early-fusion multimodality: 48 layers, d_model 5120,
40 heads GQA (8 KV), 16 routed experts top-1 plus one shared expert
(d_ff 8192), vocab 202048.  The vision encoder is a STUB: early-fusion
patch embeddings arrive precomputed (DESIGN.md).
A copy of ``repro.configs.llama4_scout``, registered under the same name.
"""
from .base import ArchConfig, BlockSpec, MoEConfig, register


@register("llama4-scout-17b-a16e")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        pattern=(BlockSpec(mixer="attn", moe=True),),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=500_000.0,
        moe=MoEConfig(num_experts=16, top_k=1, num_shared=1,
                      capacity_factor=1.25),
        frontend="vision",
        frontend_tokens=256,
        sharding_policy="node_fsdp",
        n_nodes=4,
    )
