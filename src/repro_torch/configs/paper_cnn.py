"""The paper's own models: GN-LeNet CNNs for CIFAR-10 / FEMNIST
(DecentralizePy defaults; Morph §IV-A2).  A copy of
``repro.configs.paper_cnn``."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str
    in_channels: int
    num_classes: int
    image_size: int
    width: int = 32


CIFAR10_CNN = CNNConfig(name="cifar10-gn-lenet", in_channels=3,
                        num_classes=10, image_size=32)
FEMNIST_CNN = CNNConfig(name="femnist-gn-lenet", in_channels=1,
                        num_classes=62, image_size=28)


DATASETS = {"cifar10": CIFAR10_CNN, "femnist": FEMNIST_CNN}


def get_cnn_config(dataset: str) -> CNNConfig:
    """The paper CNN for ``dataset``; raises :class:`ValueError` naming
    the valid dataset keys on an unknown name."""
    try:
        return DATASETS[dataset]
    except KeyError:
        raise ValueError(
            f"unknown dataset {dataset!r}; valid datasets: "
            f"{', '.join(sorted(DATASETS))}") from None
