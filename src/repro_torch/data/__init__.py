"""Data substrate: synthetic datasets, non-IID partitioning, per-node
batch pipelines."""
from .partition import (by_writer_partition, dirichlet_partition,
                        heterogeneity, label_distributions)
from .pipeline import (DeviceDataStream, NodeBatcher, StackedBatcher,
                       TokenBatcher, stack_streams)
from .synthetic import (ImageDataset, make_image_classification,
                        make_token_stream, train_test_split)

__all__ = ["by_writer_partition", "dirichlet_partition", "heterogeneity",
           "label_distributions", "DeviceDataStream", "NodeBatcher",
           "StackedBatcher", "TokenBatcher", "stack_streams", "ImageDataset",
           "make_image_classification", "make_token_stream",
           "train_test_split"]
