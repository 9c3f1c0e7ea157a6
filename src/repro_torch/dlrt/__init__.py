"""Decentralized-learning runtime: the runner (its host loop and the dense
and sparse round engines) and the round-domain metrics."""
from .metrics import (MetricsLog, RoundRecord, internode_variance,
                      net_staleness_mean)
from .runtime import (DecentralizedRunner, RunnerConfig, evaluate_record,
                      host_params, make_evaluator, make_local_step,
                      make_round_record, stacked_model_bytes)
from .superstep import Superstep, eval_boundaries

__all__ = ["MetricsLog", "RoundRecord", "internode_variance",
           "net_staleness_mean",
           "DecentralizedRunner", "RunnerConfig", "evaluate_record",
           "host_params", "make_evaluator",
           "make_local_step", "make_round_record", "stacked_model_bytes",
           "Superstep", "eval_boundaries"]
