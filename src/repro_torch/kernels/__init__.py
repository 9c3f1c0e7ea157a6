"""Hand-written Hopper kernels (``csrc/*.cu``) for the three TPU kernels on
the dense Morph path, with their plain PyTorch versions (:mod:`.ref`) and
the parameter-dict wrappers (:mod:`.ops`)."""
from .graph_mix import graph_mix, graph_mix_masked
from .pairwise_cosine import gram_matrix

KERNELS = (gram_matrix, graph_mix, graph_mix_masked)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for kernel in KERNELS:
        kernel.launches = 0


__all__ = ["KERNELS", "graph_mix", "graph_mix_masked", "gram_matrix",
           "reset_launches"]
