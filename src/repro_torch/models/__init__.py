"""Models the port trains."""
from .cnn import cnn_forward, cnn_loss, cnn_params

__all__ = ["cnn_forward", "cnn_loss", "cnn_params"]
