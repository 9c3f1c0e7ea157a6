"""Machine-readable benchmark records — the port of
``benchmarks/harness.py``'s schema, written without JAX.

Each script builds one :class:`Bench`, records its rows with
:meth:`Bench.record` (stdout keeps the ``name,key,value`` CSV lines), and
calls :meth:`Bench.finish` to write ``$BENCH_DIR/BENCH_<name>.json``.
``BENCH_DIR`` defaults to the working directory; an empty ``BENCH_DIR``
turns the JSON side off.

File schema (``schema_version`` = :data:`SCHEMA_VERSION`)::

    {"schema_version": 1, "name": "torch_fig3_accuracy",
     "created_unix": 1e9, "backend": "cuda" | "cpu", "torch": "2.x",
     "records": [{"key": "final/morph_n50", "value": 0.46,
                  "shape": {"backend", "n", "d", "devices", "net"},  # opt
                  "knobs": {...}, "wall_clock_s": 1.2,               # opt
                  "fidelity": {...}}, ...]}                          # opt

The reference writes ``"jax": <version>`` where this writes ``"torch"``,
and its HLO-cost columns have no counterpart here.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch

SCHEMA_VERSION = 1


def _num(value):
    """A CSV value as a number when it parses (an int when it has no
    point or exponent), else a string."""
    if isinstance(value, (int, float)):
        return value
    try:
        f = float(str(value))
    except (TypeError, ValueError):
        return str(value)
    return int(f) if f.is_integer() and "." not in str(value) \
        and "e" not in str(value).lower() else f


class Bench:
    """Recorder for one benchmark script (see the module docstring);
    ``backend`` is the device type the script ran on."""

    def __init__(self, name: str, backend: str,
                 out_dir: Optional[str] = None):
        self.name = name
        self.backend = backend
        self.out_dir = os.environ.get("BENCH_DIR", ".") if out_dir is None \
            else out_dir
        self.records: list = []

    def record(self, key, value=None, *, shape: Optional[Dict] = None,
               knobs: Optional[Dict] = None,
               wall_clock_s: Optional[float] = None,
               fidelity: Optional[Dict] = None,
               print_csv: bool = True, **extra) -> Dict:
        """Store one record; prints ``name,key,value`` unless told not
        to.  Returns the record."""
        rec: Dict = {"key": str(key)}
        if value is not None:
            rec["value"] = _num(value)
            if print_csv:
                print(f"{self.name},{key},{value}", flush=True)
        for field, v in (("shape", shape), ("knobs", knobs),
                         ("wall_clock_s", wall_clock_s),
                         ("fidelity", fidelity)):
            if v is not None:
                rec[field] = v
        rec.update(extra)
        self.records.append(rec)
        return rec

    def finish(self) -> Optional[str]:
        """Write ``BENCH_<name>.json``; returns its path (None when
        ``BENCH_DIR`` is empty)."""
        if not self.out_dir:
            return None
        payload = {"schema_version": SCHEMA_VERSION, "name": self.name,
                   "created_unix": time.time(), "backend": self.backend,
                   "torch": torch.__version__, "records": self.records}
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"BENCH_{self.name}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        return path


def shape_dict(cfg, params, backend: str) -> Dict:
    """The run's shape as the reference records it: backend, n, the
    per-node parameter count d, devices (1) and the network depth (0)."""
    n = cfg.n_nodes
    return {"backend": backend, "n": n,
            "d": sum(v.numel() // n for v in params.values()),
            "devices": 1, "net": 0}
