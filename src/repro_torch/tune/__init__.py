"""Autotuning for the round engine's knobs — the port of ``repro.tune``.

``repro_torch.tune`` resolves ``RunnerConfig``'s ``"auto"`` sentinels
(``chunk``, ``engine``, ``compress``) from a versioned on-disk cache keyed
by ``(backend, n, D, devices, net)``, in the reference's format, and
provides the two-stage tuner that fills it: a short timed probe of every
candidate, pruned as the reference prunes, then a longer timing of the
survivors.  See ``python -m repro_torch.tune --help``.
"""
from .cache import (CACHE_VERSION, DEFAULT_CACHE_PATH, ENV_CACHE,
                    TuneEntry, TuneShape, TuningCache, load_default_cache)
from .resolve import AUTO, ResolvedKnobs, resolve_knobs, shape_of
from .space import (DEFAULT_CHUNKS, DEFAULT_COMPRESS,
                    DEFAULT_SPARSE_CANDIDATES, Candidate, candidate_space)
from .tuner import TuneResult, prune, time_engine, tune, tune_into
from .workload import mlp_runner_factory, sweep_runner_factory

__all__ = ["CACHE_VERSION", "DEFAULT_CACHE_PATH", "ENV_CACHE",
           "TuneEntry", "TuneShape", "TuningCache", "load_default_cache",
           "AUTO", "ResolvedKnobs", "resolve_knobs", "shape_of",
           "DEFAULT_CHUNKS", "DEFAULT_COMPRESS",
           "DEFAULT_SPARSE_CANDIDATES", "Candidate", "candidate_space",
           "TuneResult", "prune", "time_engine", "tune", "tune_into",
           "mlp_runner_factory", "sweep_runner_factory"]
