"""Decentralized-learning runtime: the runner (its host loop and the dense
and sparse round engines, on one device or sharded over the ranks of a
process group), the sweep farm (E experiments stacked on one device), the
model zoo's decentralized train and serve steps with their sharding
policies on the production mesh (both also over a ``DeviceMesh``, their
state DTensors), and the round- and wall-clock-domain
metrics."""
from .distributed import (MorphHParams, NamedSharding, PartitionSpec,
                          TrainState, abstract_cache,
                          abstract_stacked_params, abstract_train_state,
                          batch_sharding, cache_sharding, cache_spec,
                          init_node_caches, init_train_state, leaf_spec,
                          make_prefill_step, make_serve_step,
                          make_train_step, node_axes,
                          params_sharding, placements, replicated,
                          serve_kv_spec, shard_shape,
                          superstep_node_sharding, train_state_sharding,
                          train_state_to)
from .mesh_serve import (distribute_cache, distribute_params, gather_tree,
                         init_mesh_caches)
from .mesh_step import distribute_train_state, gather_train_state
from .metrics import (MetricsLog, NetMetricsLog, NetRecord, RoundRecord,
                      internode_variance, net_staleness_mean)
from .runtime import (DecentralizedRunner, RunnerConfig, evaluate_record,
                      host_params, make_evaluator, make_local_step,
                      make_round_record, stacked_model_bytes)
from .sharded import COLLECTIVES, ShardedSuperstep
from .superstep import Superstep, eval_boundaries
from .sweep import SweepSpec, SweepSuperstep

__all__ = ["MorphHParams", "NamedSharding", "PartitionSpec", "TrainState",
           "abstract_cache", "abstract_stacked_params",
           "abstract_train_state", "batch_sharding", "cache_sharding",
           "cache_spec", "init_node_caches", "init_train_state",
           "leaf_spec", "make_prefill_step", "make_serve_step",
           "make_train_step", "node_axes",
           "params_sharding", "placements", "replicated", "serve_kv_spec",
           "shard_shape", "superstep_node_sharding",
           "train_state_sharding", "train_state_to",
           "distribute_train_state", "gather_train_state",
           "distribute_cache", "distribute_params", "gather_tree",
           "init_mesh_caches", "COLLECTIVES",
           "MetricsLog", "NetMetricsLog", "NetRecord",
           "RoundRecord", "internode_variance", "net_staleness_mean",
           "DecentralizedRunner", "RunnerConfig", "evaluate_record",
           "host_params", "make_evaluator",
           "make_local_step", "make_round_record", "stacked_model_bytes",
           "ShardedSuperstep", "Superstep", "eval_boundaries", "SweepSpec",
           "SweepSuperstep"]
