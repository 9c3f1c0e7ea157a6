"""Nemotron-4-340B [arXiv:2402.16819 (Nemotron-4 15B), 2406.11704 (340B)].

Dense decoder at the largest assigned scale: 96 layers, d_model 18432,
96 heads GQA (8 KV), **squared-ReLU** MLP d_ff 73728, vocab 256000.
A copy of ``repro.configs.nemotron_4_340b``, registered under the same name.
"""
from .base import ArchConfig, register


@register("nemotron-4-340b")
def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        citation="arXiv:2402.16819 (Nemotron-4)",
        num_layers=96,
        d_model=18432,
        num_heads=96,
        num_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        mlp_type="sqrelu",
        norm_type="layernorm",
        rope_theta=10_000.0,
        sharding_policy="node_fsdp",
        n_nodes=2,
    )
