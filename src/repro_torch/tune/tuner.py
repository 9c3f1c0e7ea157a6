"""Two-stage round-engine autotuner — the port of ``repro.tune.tuner``.

**Stage 1 — probe, prune.**  The reference lowers every candidate's
superstep and costs its XLA HLO (``analyse_hlo``, ``PEAKS``,
``stage1_score``).  A torch program has no HLO to cost, so the port
instead *times a short probe* of every candidate: a fresh engine, one
warm chunk, then ``probe_rounds`` rounds (rounded up to whole chunks).
The probes' seconds a round prune the space with the reference's
:func:`prune`: candidates more than ``prune_ratio`` x the best are
dropped, the rest capped at ``keep``, and the best candidate of every
engine always survives.

**Stage 2 — time the survivors.**  Each survivor gets a fresh engine, two
warm chunks, then a timed ``run_steps`` of ``rounds`` rounds; the argmin
seconds a round wins and is persisted as a :class:`TuneEntry`.

Both stages call the injectable ``timer(engine, chunk, rounds,
warm_chunks)``, so tests can replace the clock.  On the card the timer
brackets the timed run with ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import math
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..bench.harness import synchronize
from .cache import TuneEntry, TuneShape, TuningCache
from .resolve import shape_of
from .space import Candidate, candidate_space


@dataclass
class TuneResult:
    """Everything one :func:`tune` call learned: the stage-1 probe and
    the stage-2 seconds a round per candidate."""
    shape: TuneShape
    best: Candidate
    survivors: List[Candidate]
    stage1_scores: Dict[Candidate, float] = field(default_factory=dict)
    seconds_per_round: Dict[Candidate, float] = field(default_factory=dict)

    def entry(self, **tuned) -> TuneEntry:
        """The winning candidate as a persistable cache entry."""
        return TuneEntry(
            block_d=self.best.block_d, collective=self.best.collective,
            chunk=self.best.chunk, use_pallas=self.best.use_pallas,
            engine=self.best.engine, candidates=self.best.candidates,
            compress=self.best.compress,
            seconds_per_round=self.seconds_per_round.get(self.best),
            tuned={"candidates": len(self.stage1_scores),
                   "survivors": len(self.survivors), **tuned})


def prune(scores: Dict[Candidate, float], *, prune_ratio: float = 2.0,
          keep: int = 8) -> List[Candidate]:
    """Stage-1 survivors: within ``prune_ratio`` of the best score,
    best-first, at most ``keep`` (never empty); the best-scoring candidate
    of every engine always survives, so pruning can narrow an engine's
    field but never remove an engine."""
    ranked = sorted(scores, key=lambda c: scores[c])
    best = scores[ranked[0]]
    surv = [c for c in ranked if scores[c] <= best * prune_ratio]
    surv = surv[:keep] or ranked[:1]
    engines_kept = {getattr(c, "engine", "dense") for c in surv}
    for c in ranked:
        eng = getattr(c, "engine", "dense")
        if eng not in engines_kept:
            surv.append(c)
            engines_kept.add(eng)
    return surv


def _close(engine) -> None:
    """Release a timed engine's process group, where it started one (the
    sweep adapter's engines have nothing to close)."""
    close = getattr(engine, "close", None)
    if close is not None:
        close()


def time_engine(engine, chunk: int, rounds: int,
                warm_chunks: int = 2) -> float:
    """The default timer: ``warm_chunks`` warm chunks (the first calls'
    one-time costs stay out of the measurement), then ``rounds`` rounds
    (rounded up to whole chunks) timed between two synchronisations;
    returns wall-clock seconds a round."""
    chunk = max(min(chunk, rounds), 1)
    total = math.ceil(rounds / chunk) * chunk
    engine.run_steps(warm_chunks * chunk, chunk)
    synchronize(engine.device)
    t0 = time.perf_counter()
    engine.run_steps(total, chunk)
    synchronize(engine.device)
    return (time.perf_counter() - t0) / total


def tune(make_runner: Callable[[Candidate], object], *,
         shape: Optional[TuneShape] = None,
         candidates: Optional[Sequence[Candidate]] = None,
         rounds: int = 24, probe_rounds: int = 8,
         prune_ratio: float = 2.0, keep: int = 8,
         timer: Callable = time_engine,
         verbose: bool = False) -> TuneResult:
    """Tune one shape.

    ``make_runner(candidate)`` must build a **fresh**
    :class:`~repro_torch.dlrt.DecentralizedRunner` whose config carries
    the candidate's knobs concretely (each stage consumes an engine, so
    each call starts from the same seed).  ``shape`` and ``candidates``
    default to the first runner's :func:`shape_of` and
    :func:`candidate_space`.  ``timer(engine, chunk, rounds, warm_chunks)
    -> seconds a round`` times stage 1 (``probe_rounds``, one warm chunk)
    and stage 2 (``rounds``, two warm chunks).
    """
    if shape is None:
        probe = make_runner(Candidate())
        shape = shape_of(probe.cfg, probe.params)
    if candidates is None:
        candidates = candidate_space(shape)

    result = TuneResult(shape=shape, best=candidates[0], survivors=[])
    for cand in candidates:
        engine = make_runner(cand)._make_engine()
        try:
            spr = timer(engine, cand.chunk, probe_rounds, 1)
        finally:
            _close(engine)
        result.stage1_scores[cand] = spr
        if verbose:
            print(f"tune,stage1,{shape.key()},{cand.label()},"
                  f"{spr * 1e3:.3f}ms/round", flush=True)

    result.survivors = prune(result.stage1_scores,
                             prune_ratio=prune_ratio, keep=keep)
    for cand in result.survivors:
        engine = make_runner(cand)._make_engine()
        try:
            spr = timer(engine, cand.chunk, rounds, 2)
        finally:
            _close(engine)
        result.seconds_per_round[cand] = spr
        if verbose:
            print(f"tune,stage2,{shape.key()},{cand.label()},"
                  f"{spr * 1e3:.3f}ms/round", flush=True)

    result.best = min(result.seconds_per_round,
                      key=lambda c: result.seconds_per_round[c])
    return result


def card_provenance(backend: str) -> Dict[str, object]:
    """Where a timing ran: the torch version and the backend, and on the
    card its name and ``nvidia-smi``'s power limit."""
    out: Dict[str, object] = {"backend": backend, "torch": torch.__version__}
    if backend == "cuda":
        out["card"] = torch.cuda.get_device_name()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout
        out["power_limit"] = smi.strip().splitlines()[0]
    return out


def tune_into(cache: TuningCache, make_runner, *,
              provenance: Optional[Dict[str, object]] = None,
              **kwargs) -> TuneResult:
    """:func:`tune`, then put the winner into ``cache`` (the caller
    saves) with its provenance: :func:`card_provenance` and
    ``provenance`` (what the workload was)."""
    result = tune(make_runner, **kwargs)
    cache.put(result.shape, result.entry(
        **card_provenance(result.shape.backend), **(provenance or {})))
    return result
