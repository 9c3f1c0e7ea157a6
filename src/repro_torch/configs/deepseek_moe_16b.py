"""DeepSeek-MoE 16B [arXiv:2401.06066].

Fine-grained MoE: 28 layers, d_model 2048, 16 heads (MHA: 16 KV heads),
64 routed experts top-6 + 2 shared experts, expert width d_ff 1408,
vocab 102400.  The fine-grained expert segmentation (narrow experts,
high top-k) is the paper's signature.
A copy of ``repro.configs.deepseek_moe_16b``, registered under the same name.
"""
from .base import ArchConfig, BlockSpec, MoEConfig, register


@register("deepseek-moe-16b")
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        citation="arXiv:2401.06066 (DeepSeekMoE)",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        pattern=(BlockSpec(mixer="attn", moe=True),),
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=10_000.0,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared=2,
                      d_ff_expert=1408, capacity_factor=1.25),
        sharding_policy="node_dp",
        n_nodes=16,
    )
