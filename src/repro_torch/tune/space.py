"""Candidate space for the round engine's knobs, per tuning shape — the
port of ``repro.tune.space`` with the reference's gating rules and order.

* ``chunk`` (rounds between host decodes) always varies;
* ``engine`` adds the sparse engine at each candidate-set size, except
  under a dense network model (``net > 0``), which the sparse engine
  does not run;
* ``collective`` adds ``"psum"`` only when the node axis is sharded
  (``devices > 1``) and no network model is on (``net == 0``), whose ring
  only the gather schedule moves;
* ``compress`` varies over the codec specs.

There are no Pallas or ``block_d`` members: every kernel is the
hand-written CUDA one, with no alternative path to choose.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .cache import TuneShape

DEFAULT_CHUNKS = (8, 16, 32, 64)
# Candidate-set sizes of the sparse candidates (None = the strategy's
# own default, min(n, 4k + 2)).
DEFAULT_SPARSE_CANDIDATES = (None, 16)
# Codec specs joined into the grid; "none" stays first so the
# uncompressed engine is always a candidate.
DEFAULT_COMPRESS = ("none", "int8", "int8+topk0.25")


@dataclass(frozen=True)
class Candidate:
    """One knob assignment the tuner times.  Fields mean what
    ``RunnerConfig``'s do; ``candidates`` is the sparse control plane's
    candidate-set size (a strategy knob, threaded through the workload
    factory).  ``block_d`` and ``use_pallas`` keep the reference's
    defaults so labels and cache entries match its own."""
    chunk: int = 32
    collective: str = "gather"
    block_d: Optional[int] = None
    use_pallas: bool = False
    engine: str = "dense"
    candidates: Optional[int] = None
    compress: str = "none"

    def label(self) -> str:
        """Short tag for logs and cache provenance (the reference's)."""
        parts = [f"chunk={self.chunk}", self.collective]
        if self.engine != "dense":
            c = "strategy" if self.candidates is None else self.candidates
            parts.append(f"{self.engine}(c={c})")
        if self.use_pallas:
            parts.append(f"pallas(block_d={self.block_d})")
        if self.compress != "none":
            parts.append(self.compress)
        return "/".join(parts)


def candidate_space(shape: TuneShape, *,
                    chunks: Sequence[int] = DEFAULT_CHUNKS,
                    include_sparse: bool = True,
                    sparse_candidates: Sequence[Optional[int]]
                    = DEFAULT_SPARSE_CANDIDATES,
                    compress_options: Sequence[str]
                    = DEFAULT_COMPRESS) -> List[Candidate]:
    """Deterministically ordered candidates for ``shape``: chunk, then
    collective, then engine, then codec, as the reference orders its space
    without Pallas members (see the module docstring for the gating
    rules)."""
    collectives = ["gather"]
    if shape.devices > 1 and shape.net == 0:
        collectives.append("psum")
    engines = [("dense", None)]
    if include_sparse and shape.net == 0:
        engines += [("sparse", cc) for cc in sparse_candidates]
    return [Candidate(chunk=c, collective=col, engine=eng, candidates=cc,
                      compress=comp)
            for c in chunks
            for col in collectives
            for eng, cc in engines
            for comp in compress_options]
