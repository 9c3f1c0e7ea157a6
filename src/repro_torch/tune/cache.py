"""Versioned on-disk tuning cache — the port of ``repro.tune.cache``.

One JSON file maps *shape keys* — ``(backend, n, D, devices, net[,
sweep])`` canonicalized by :meth:`TuneShape.key` — to the knob assignment
the tuner picked for that shape.  The schema and the key format are the
reference's, so a file either package writes loads in the other with
equal fields.  A file of another ``schema_version`` loads as an empty
cache (stale entries must never steer a newer engine), which ``"auto"``
resolution treats as "no entry": the hand-set defaults.

``backend`` is the runner's ``device.type`` (``"cuda"`` or ``"cpu"``).
The committed default file, ``cuda_default.json``, was tuned on the card
by ``python -m repro_torch.tune``; it holds no ``cpu|...`` entry, so on
the CPU ``"auto"`` gives the defaults.  ``REPRO_TORCH_TUNE_CACHE`` points
resolution at another file.  ``TuneEntry`` keeps the reference's
``block_d`` and ``use_pallas`` fields: the port records them as written
and never reads them (the card's kernels pick their own tiles);
``collective`` is the sharded engine's schedule, read by ``"auto"``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

CACHE_VERSION = 1
ENV_CACHE = "REPRO_TORCH_TUNE_CACHE"
DEFAULT_CACHE_PATH = Path(__file__).parent / "cuda_default.json"


@dataclass(frozen=True)
class TuneShape:
    """The cache key: what a run's best knobs depend on, coarse-grained to
    stay portable across workloads with the same footprint."""
    backend: str                 # the runner's device.type: cuda / cpu
    n: int                       # population size
    d: int                       # per-node flattened parameter count
    devices: int = 1             # node-axis shard count (1 = one device)
    net: int = 0                 # dense-network ring depth S (0 = none)
    sweep: int = 0               # stacked experiment count E (0 = the
                                 # single-trajectory engine)

    def key(self) -> str:
        """Canonical string key; ``sweep`` is appended only when nonzero,
        as the reference's is."""
        base = (f"{self.backend}|n={self.n}|d={self.d}"
                f"|devices={self.devices}|net={self.net}")
        return base if self.sweep == 0 else f"{base}|sweep={self.sweep}"


@dataclass(frozen=True)
class TuneEntry:
    """One resolved knob assignment.  Field defaults are the engine's
    hand-set defaults, so ``TuneEntry()`` is the no-entry fallback."""
    block_d: Optional[int] = None        # recorded, not read (reference
                                         # kernel D-block)
    collective: str = "gather"           # sharded mixing schedule
    chunk: Optional[int] = None          # rounds between host decodes
    use_pallas: bool = False             # recorded, not read
    engine: str = "dense"                # data plane: dense | sparse
    candidates: Optional[int] = None     # sparse candidate-set size
                                         # (recorded; a strategy knob)
    compress: str = "none"               # gossip codec spec
    seconds_per_round: Optional[float] = None   # stage-2 measurement
    tuned: Dict[str, object] = field(default_factory=dict)  # provenance


class TuningCache:
    """In-memory view of one cache file: ``get``/``put`` by
    :class:`TuneShape`, round-tripped through versioned JSON."""

    def __init__(self, entries: Optional[Dict[str, TuneEntry]] = None):
        self.entries: Dict[str, TuneEntry] = dict(entries or {})

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, shape: TuneShape) -> Optional[TuneEntry]:
        """The entry for ``shape``, or None (exact key match only)."""
        return self.entries.get(shape.key())

    def put(self, shape: TuneShape, entry: TuneEntry) -> None:
        """Insert or replace the entry for ``shape``."""
        self.entries[shape.key()] = entry

    @classmethod
    def load(cls, path) -> "TuningCache":
        """Load ``path``; a missing or unreadable file or another
        ``schema_version`` gives an empty cache, and fields the entry
        does not know are ignored."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return cls()
        if payload.get("schema_version") != CACHE_VERSION:
            return cls()
        names = {f.name for f in dataclasses.fields(TuneEntry)}
        return cls({key: TuneEntry(**{k: v for k, v in raw.items()
                                      if k in names})
                    for key, raw in payload.get("entries", {}).items()})

    def save(self, path) -> None:
        """Write the versioned JSON (parent directories created)."""
        payload = {
            "schema_version": CACHE_VERSION,
            "entries": {key: dataclasses.asdict(e)
                        for key, e in sorted(self.entries.items())},
        }
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")


def load_default_cache() -> TuningCache:
    """The cache ``"auto"`` resolution reads: ``$REPRO_TORCH_TUNE_CACHE``
    when set, else the committed ``cuda_default.json``."""
    return TuningCache.load(os.environ.get(ENV_CACHE) or DEFAULT_CACHE_PATH)
