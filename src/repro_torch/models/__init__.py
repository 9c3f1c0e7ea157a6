"""Models the port runs: the paper's CNNs and tiny MLP (trained by the
Morph engines) and the model zoo (attention, Mamba and RWKV-6 mixers,
dense and MoE MLPs, the transformer stack and the arch-agnostic ``model``
API)."""
from . import attention, layers, mamba, model, moe, rwkv, transformer
from .cnn import cnn_forward, cnn_loss, cnn_params
from .tiny import mlp_loss, mlp_params

__all__ = ["attention", "cnn_forward", "cnn_loss", "cnn_params", "layers",
           "mamba", "mlp_loss", "mlp_params", "model", "moe", "rwkv",
           "transformer"]
