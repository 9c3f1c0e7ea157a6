"""Morph's core as tensor code: similarity, selection, matching, the
controller, mixing and the topology strategies."""
from .baselines import (InGraphEpidemicStrategy,
                        InGraphFullyConnectedStrategy, InGraphMorphStrategy,
                        InGraphStaticStrategy)
from .matching import masked_topk, match_dense
from .mixing import (apply_mixing, fully_connected_weights,
                     metropolis_hastings_weights, uniform_weights,
                     uniform_weights_torch)
from .morph import (MorphGraphState, MorphNoise, draw_noise, init_state,
                    update_topology)
from .selection import (NEG_INF, random_injection, sample_gumbel_topk,
                        scatter_or, softmax_logits, stable_topk)
from .similarity import (layer_cosine, model_similarity,
                         pairwise_model_similarity)
from .topology import (fully_connected, in_degrees, is_connected,
                       isolated_nodes, random_regular_graph)

__all__ = [
    "InGraphEpidemicStrategy", "InGraphFullyConnectedStrategy",
    "InGraphMorphStrategy", "InGraphStaticStrategy", "masked_topk",
    "match_dense", "apply_mixing", "fully_connected_weights",
    "metropolis_hastings_weights", "uniform_weights",
    "uniform_weights_torch", "MorphGraphState", "MorphNoise", "draw_noise",
    "init_state", "update_topology", "NEG_INF", "random_injection",
    "sample_gumbel_topk", "scatter_or", "softmax_logits", "stable_topk",
    "layer_cosine", "model_similarity", "pairwise_model_similarity",
    "fully_connected", "in_degrees", "is_connected", "isolated_nodes",
    "random_regular_graph",
]
