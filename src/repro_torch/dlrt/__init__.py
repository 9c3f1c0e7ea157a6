"""Decentralized-learning runtime: the runner, the dense and sparse round
engines and the round-domain metrics."""
from .metrics import (MetricsLog, RoundRecord, internode_variance,
                      net_staleness_mean)
from .runtime import (DecentralizedRunner, RunnerConfig, make_evaluator,
                      make_local_step, make_round_record,
                      stacked_model_bytes)
from .superstep import Superstep, eval_boundaries

__all__ = ["MetricsLog", "RoundRecord", "internode_variance",
           "net_staleness_mean",
           "DecentralizedRunner", "RunnerConfig", "make_evaluator",
           "make_local_step", "make_round_record", "stacked_model_bytes",
           "Superstep", "eval_boundaries"]
