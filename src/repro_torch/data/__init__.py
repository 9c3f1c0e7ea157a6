"""Data substrate: synthetic datasets, non-IID partitioning, per-node
batch pipelines."""
from .partition import (by_writer_partition, dirichlet_partition,
                        heterogeneity, label_distributions)
from .pipeline import (DeviceDataStream, NodeBatcher, StackedBatcher,
                       stack_streams)
from .synthetic import ImageDataset, make_image_classification, train_test_split

__all__ = ["by_writer_partition", "dirichlet_partition", "heterogeneity",
           "label_distributions", "DeviceDataStream", "NodeBatcher",
           "StackedBatcher", "stack_streams", "ImageDataset",
           "make_image_classification", "train_test_split"]
