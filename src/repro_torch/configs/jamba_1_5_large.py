"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887, 2408.12570].

Hybrid Mamba-Transformer: periods of 8 layers with a 1:7 attention:Mamba
ratio and MoE (16 experts, top-2) on every other layer.  72 layers =
9 periods.  GQA with 8 KV heads on the attention layers.  A copy of
``repro.configs.jamba_1_5_large``, registered under the same name.
"""
from .base import ArchConfig, BlockSpec, MoEConfig, SSMConfig, register

_PATTERN = tuple(
    BlockSpec(mixer=("attn" if i == 4 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)


@register("jamba-1.5-large-398b")
def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        citation="arXiv:2403.19887 (Jamba), arXiv:2408.12570 (Jamba-1.5)",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        pattern=_PATTERN,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=None,          # Jamba uses no positional encoding
        moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25),
        ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2,
                      chunk=64),
        sharding_policy="node_fsdp",
        n_nodes=2,
        max_position=1 << 19,     # 512k context
    )
