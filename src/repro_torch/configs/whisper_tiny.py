"""Whisper-tiny [arXiv:2212.04356].

Encoder-decoder: 4+4 layers, d_model 384, 6 heads (MHA), GELU d_ff 1536,
vocab 51865, learned positions, LayerNorm, QKV bias.  The mel-spectrogram
conv frontend is a STUB (DESIGN.md): inputs are 1500 precomputed frame
embeddings.  Decoder positions are 448 by spec; ``decode_32k`` lowers a
32k self-attn cache as a structural proof (DESIGN.md §4), ``long_500k``
is skipped for this arch.
A copy of ``repro.configs.whisper_tiny``, registered under the same name.
"""
from .base import ArchConfig, EncoderConfig, register


@register("whisper-tiny")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        citation="arXiv:2212.04356 (Whisper)",
        num_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        mlp_type="gelu",
        norm_type="layernorm",
        qkv_bias=True,
        rope_theta=None,
        learned_pos=True,
        tie_embeddings=True,
        encoder=EncoderConfig(num_layers=4, seq_len=1500),
        frontend="audio",
        max_position=448,
        sharding_policy="node_dp",
        n_nodes=16,
        param_dtype="bfloat16",
    )
