"""Models the port trains."""
from .cnn import cnn_forward, cnn_loss, cnn_params
from .tiny import mlp_loss, mlp_params

__all__ = ["cnn_forward", "cnn_loss", "cnn_params", "mlp_loss", "mlp_params"]
