"""Hand-written Hopper kernels (``csrc/*.cu``) for the TPU kernels on the
dense and sparse Morph paths and on the model zoo's Mamba layers (the
scan, and its backward for training), with their plain PyTorch versions
(:mod:`.ref`) and the parameter-dict wrappers (:mod:`.ops`)."""
from .graph_mix import (graph_mix, graph_mix_leaves, graph_mix_masked,
                        graph_mix_masked_leaves)
from .graph_mix_sparse import graph_mix_sparse, graph_mix_sparse_leaves
from .pairwise_cosine import gram_matrices, gram_matrix
from .selective_scan import selective_scan, selective_scan_bwd

KERNELS = (gram_matrix, graph_mix, graph_mix_masked, graph_mix_sparse,
           selective_scan, selective_scan_bwd)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for kernel in KERNELS:
        kernel.launches = 0


__all__ = ["KERNELS", "graph_mix", "graph_mix_leaves", "graph_mix_masked",
           "graph_mix_masked_leaves", "graph_mix_sparse",
           "graph_mix_sparse_leaves", "gram_matrices",
           "gram_matrix", "reset_launches", "selective_scan",
           "selective_scan_bwd"]
