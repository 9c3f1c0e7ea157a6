"""Morph's core: similarity, selection, matching, the controller, mixing,
the topology strategies and the message-faithful protocol."""
from .baselines import (EpidemicStrategy, FullyConnectedStrategy,
                        InGraphEpidemicLocalStrategy,
                        InGraphEpidemicStrategy,
                        InGraphFullyConnectedStrategy, InGraphMorphStrategy,
                        InGraphStaticStrategy, StaticStrategy,
                        TopologyStrategy)
from .matching import deferred_acceptance, masked_topk, match_dense
from .mixing import (apply_consensus_correction, apply_mixing,
                     apply_mixing_compressed, fully_connected_weights,
                     is_doubly_stochastic, is_row_stochastic,
                     metropolis_hastings_weights, mix_numpy,
                     tensordot_mix_leaf, uniform_weights,
                     uniform_weights_torch)
from .morph import (MorphGraphState, MorphNoise, draw_noise, init_state,
                    mix_round, update_topology)
from .protocol import (ConnectAccept, ConnectReject, ConnectRequest,
                       GossipDigest, MorphConfig, MorphNodeState,
                       MorphProtocol, NegotiationPlan)
from .selection import (NEG_INF, random_injection, sample_gumbel_topk,
                        sample_sequential, scatter_or, softmax_logits,
                        stable_topk, update_wanted_senders,
                        update_wanted_senders_host)
from .similarity import (HISTORY_DEPTH, SimilarityHistory, SimilarityReport,
                         angular_bound, dissimilarity, layer_cosine,
                         model_similarity, node_row, pair_similarity_numpy,
                         pairwise_model_similarity, similarity_matrix_numpy)
from .topology import (TopologyState, comm_cost, connectivity_probability,
                       fully_connected, in_degrees, is_connected,
                       isolated_nodes, out_degrees, random_out_regular,
                       random_regular_graph)

__all__ = [
    "EpidemicStrategy", "FullyConnectedStrategy",
    "InGraphEpidemicLocalStrategy", "InGraphEpidemicStrategy",
    "InGraphFullyConnectedStrategy", "InGraphMorphStrategy",
    "InGraphStaticStrategy", "StaticStrategy", "TopologyStrategy",
    "deferred_acceptance", "masked_topk", "match_dense",
    "apply_consensus_correction", "apply_mixing", "apply_mixing_compressed",
    "fully_connected_weights", "is_doubly_stochastic", "is_row_stochastic",
    "metropolis_hastings_weights", "mix_numpy", "tensordot_mix_leaf",
    "uniform_weights", "uniform_weights_torch", "MorphGraphState",
    "MorphNoise", "draw_noise", "init_state", "mix_round",
    "update_topology",
    "ConnectAccept", "ConnectReject", "ConnectRequest", "GossipDigest",
    "MorphConfig", "MorphNodeState", "MorphProtocol", "NegotiationPlan",
    "NEG_INF", "random_injection", "sample_gumbel_topk", "sample_sequential",
    "scatter_or", "softmax_logits", "stable_topk", "update_wanted_senders",
    "update_wanted_senders_host", "HISTORY_DEPTH", "SimilarityHistory",
    "SimilarityReport", "angular_bound", "dissimilarity", "layer_cosine",
    "model_similarity", "node_row", "pair_similarity_numpy",
    "pairwise_model_similarity", "similarity_matrix_numpy",
    "TopologyState", "comm_cost", "connectivity_probability",
    "fully_connected", "in_degrees", "is_connected", "isolated_nodes",
    "out_degrees", "random_out_regular", "random_regular_graph",
]
