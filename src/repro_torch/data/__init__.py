"""Data substrate: synthetic datasets, non-IID partitioning, per-node
batch pipelines."""
from .partition import dirichlet_partition
from .pipeline import (DeviceDataStream, NodeBatcher, StackedBatcher,
                       stack_streams)
from .synthetic import ImageDataset, make_image_classification, train_test_split

__all__ = ["dirichlet_partition", "DeviceDataStream", "NodeBatcher",
           "StackedBatcher", "stack_streams", "ImageDataset", "make_image_classification",
           "train_test_split"]
