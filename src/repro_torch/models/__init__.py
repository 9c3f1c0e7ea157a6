"""Models the port runs: the paper's CNNs and tiny MLP (trained by the
Morph engines) and the model zoo's serving path (attention and Mamba
mixers, the transformer stack and the arch-agnostic ``model`` API)."""
from . import attention, layers, mamba, model, transformer
from .cnn import cnn_forward, cnn_loss, cnn_params
from .tiny import mlp_loss, mlp_params

__all__ = ["attention", "cnn_forward", "cnn_loss", "cnn_params", "layers",
           "mamba", "mlp_loss", "mlp_params", "model", "transformer"]
