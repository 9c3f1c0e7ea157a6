"""Model configurations the port runs: the paper's GN-LeNet CNNs, and the
model zoo's architecture configs (copies of ``repro.configs``, every
name of ``ASSIGNED`` registered: Jamba, the four dense decoders,
DeepSeek-MoE, RWKV-6, Whisper-tiny and the two stub-frontend models,
Pixtral-12B and Llama-4-Scout).

``get_config("<id>")`` returns the exact published configuration;
``get_config("<id>").reduced()`` is the CPU smoke-test variant.
"""
from .base import (ArchConfig, BlockSpec, EncoderConfig, MoEConfig,
                   SSMConfig, get_config, list_configs, register)
from .paper_cnn import (CIFAR10_CNN, DATASETS, FEMNIST_CNN, CNNConfig,
                        get_cnn_config)

ASSIGNED = (
    "jamba-1.5-large-398b",
    "qwen1.5-110b",
    "rwkv6-7b",
    "whisper-tiny",
    "llama3.2-3b",
    "phi4-mini-3.8b",
    "deepseek-moe-16b",
    "llama4-scout-17b-a16e",
    "nemotron-4-340b",
    "pixtral-12b",
)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (deepseek_moe_16b, jamba_1_5_large,   # noqa: F401
                   llama3_2_3b, llama4_scout, nemotron_4_340b, phi4_mini,
                   pixtral_12b, qwen1_5_110b, rwkv6_7b, whisper_tiny)
    _LOADED = True


__all__ = ["ASSIGNED", "ArchConfig", "BlockSpec", "CIFAR10_CNN", "CNNConfig",
           "DATASETS", "EncoderConfig", "FEMNIST_CNN", "MoEConfig",
           "SSMConfig", "get_cnn_config", "get_config", "list_configs",
           "register"]
