"""RWKV-6 "Finch" 7B [arXiv:2404.05892].

Attention-free: 32 RWKV blocks (time-mix + channel-mix), d_model 4096,
64 WKV heads of head_dim 64, channel-mix d_ff 14336 (3.5x), vocab 65536.
Data-dependent decay is the v6 signature.  ``long_500k`` is native:
decode carries an O(1) per-head state.
A copy of ``repro.configs.rwkv6_7b``, registered under the same name.
"""
from .base import ArchConfig, BlockSpec, SSMConfig, register


@register("rwkv6-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b",
        family="ssm",
        citation="arXiv:2404.05892 (RWKV-6 Finch)",
        num_layers=32,
        d_model=4096,
        num_heads=64,            # WKV heads (head_dim 64)
        num_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        pattern=(BlockSpec(mixer="rwkv"),),
        norm_type="layernorm",   # RWKV uses LayerNorm
        rope_theta=10000.0,      # unused (no attention layers)
        ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=64),
        sharding_policy="node_dp",
        n_nodes=16,
        max_position=1 << 20,
    )
