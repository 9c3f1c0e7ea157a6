"""Decentralized-learning runtime: the runner (its host loop and the dense
and sparse round engines, on one device or sharded over the ranks of a
process group), the sweep farm (E experiments stacked on one device), the
model zoo's decentralized train and serve steps, and the round- and
wall-clock-domain metrics."""
from .distributed import (MorphHParams, TrainState, init_node_caches,
                          init_train_state, make_serve_step, make_train_step,
                          train_state_to)
from .metrics import (MetricsLog, NetMetricsLog, NetRecord, RoundRecord,
                      internode_variance, net_staleness_mean)
from .runtime import (DecentralizedRunner, RunnerConfig, evaluate_record,
                      host_params, make_evaluator, make_local_step,
                      make_round_record, stacked_model_bytes)
from .sharded import COLLECTIVES, ShardedSuperstep
from .superstep import Superstep, eval_boundaries
from .sweep import SweepSpec, SweepSuperstep

__all__ = ["MorphHParams", "TrainState", "init_node_caches",
           "init_train_state", "make_serve_step", "make_train_step",
           "train_state_to", "COLLECTIVES", "MetricsLog", "NetMetricsLog", "NetRecord",
           "RoundRecord", "internode_variance", "net_staleness_mean",
           "DecentralizedRunner", "RunnerConfig", "evaluate_record",
           "host_params", "make_evaluator",
           "make_local_step", "make_round_record", "stacked_model_bytes",
           "ShardedSuperstep", "Superstep", "eval_boundaries", "SweepSpec",
           "SweepSuperstep"]
