"""Model configurations the port runs."""
from .paper_cnn import (CIFAR10_CNN, DATASETS, FEMNIST_CNN, CNNConfig,
                        get_cnn_config)

__all__ = ["CIFAR10_CNN", "DATASETS", "FEMNIST_CNN", "CNNConfig",
           "get_cnn_config"]
