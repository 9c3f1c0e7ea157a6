"""The sparse engine's parts (DESIGN.md §11): CSR k-sparse adjacency,
O(n k D) mixing through the CSR kernel (and, for a sharded engine's row
block, in plain PyTorch), and gossiped candidate-set peer discovery — the
path ``RunnerConfig(engine="sparse")`` selects."""
from .adjacency import (SparseAdjacency, dense_to_csr, pad_adjacency,
                        renormalize_drops, to_dense, uniform_csr_weights,
                        validate, validate_against_dense)
from .discovery import (SparseDraws, SparseEpidemicStrategy,
                        SparseMorphStrategy, full_candidates,
                        gossip_candidates)
from .mix import candidate_similarity, sparse_mix_pytree, sparse_mix_rows

__all__ = [
    "SparseAdjacency", "SparseDraws", "SparseEpidemicStrategy",
    "SparseMorphStrategy", "candidate_similarity", "dense_to_csr",
    "full_candidates", "gossip_candidates", "pad_adjacency",
    "renormalize_drops", "sparse_mix_pytree",
    "sparse_mix_rows", "to_dense", "uniform_csr_weights", "validate",
    "validate_against_dense",
]
