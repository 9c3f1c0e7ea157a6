"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409].

VLM: Mistral-Nemo-style dense decoder (40 layers, d_model 5120, 32 heads
GQA 8 KV, head_dim 128 explicit, SwiGLU d_ff 14336, vocab 131072) consuming
Pixtral-ViT patch embeddings.  The ViT is a STUB: precomputed 1024-dim
patch embeddings go through a learned projector (DESIGN.md).
A copy of ``repro.configs.pixtral_12b``, registered under the same name.
"""
from .base import ArchConfig, register


@register("pixtral-12b")
def config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        citation="hf:mistralai/Pixtral-12B-2409",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,            # explicit: 32*128 = 4096 != d_model
        d_ff=14336,
        vocab_size=131072,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=1_000_000_000.0,
        frontend="vision",
        frontend_tokens=256,
        sharding_policy="node_dp",
        n_nodes=16,
    )
