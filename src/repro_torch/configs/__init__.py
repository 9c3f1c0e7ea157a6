"""Model configurations the port runs: the paper's GN-LeNet CNNs, and the
model zoo's architecture configs (copies of ``repro.configs``; only the
architectures the port runs are registered: Jamba, the four dense
decoders, DeepSeek-MoE and RWKV-6).

``get_config("<id>")`` returns the exact published configuration;
``get_config("<id>").reduced()`` is the CPU smoke-test variant.
"""
from .base import (ArchConfig, BlockSpec, EncoderConfig, MoEConfig,
                   SSMConfig, get_config, list_configs, register)
from .paper_cnn import (CIFAR10_CNN, DATASETS, FEMNIST_CNN, CNNConfig,
                        get_cnn_config)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (deepseek_moe_16b, jamba_1_5_large,   # noqa: F401
                   llama3_2_3b, nemotron_4_340b, phi4_mini, qwen1_5_110b,
                   rwkv6_7b)
    _LOADED = True


__all__ = ["ArchConfig", "BlockSpec", "CIFAR10_CNN", "CNNConfig", "DATASETS",
           "EncoderConfig", "FEMNIST_CNN", "MoEConfig", "SSMConfig",
           "get_cnn_config", "get_config", "list_configs", "register"]
