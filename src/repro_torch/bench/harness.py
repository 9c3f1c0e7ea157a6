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
and its HLO-cost columns have no counterpart here.  Its compile-only
``collective_bytes`` of a sharded program are counted here, in
:class:`CollectiveBytes`, from the collectives a sharded run makes.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import collectives

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
    per-node parameter count d, devices (the node mesh's world size) and
    the network depth (0)."""
    from ..tune.resolve import mesh_world
    n = cfg.n_nodes
    return {"backend": backend, "n": n,
            "d": sum(v.numel() // n for v in params.values()),
            "devices": mesh_world(cfg), "net": 0}


def sweep_experiment_records(b: Bench, prefix: str, spec, logs,
                             *, extra_fidelity=None) -> list:
    """One sweep's per-experiment records and their aggregate — the port
    of the reference's ``harness.sweep_experiment_records``.

    ``spec`` is the :class:`repro_torch.dlrt.SweepSpec` and ``logs`` the
    per-experiment :class:`~repro_torch.dlrt.MetricsLog` list a
    ``SweepSuperstep.run`` returned.  Experiment ``i`` lands as
    ``<prefix>/e<i>`` with its coordinates and its last record's fidelity
    (``extra_fidelity(e)`` may add columns), the spread as
    ``<prefix>/agg_mean`` and ``<prefix>/agg_std``.  Returns the final
    accuracies."""
    accs = []
    for e, log in enumerate(logs):
        rec = log.records[-1]
        fid = {"accuracy": rec.mean_accuracy, "loss": rec.mean_loss,
               "internode_variance": rec.internode_variance,
               "comm_bytes": rec.comm_bytes, **spec.describe(e)}
        if extra_fidelity is not None:
            fid.update(extra_fidelity(e))
        b.record(f"{prefix}/e{e}", f"{rec.mean_accuracy:.4f}",
                 fidelity=fid, print_csv=False)
        accs.append(rec.mean_accuracy)
    arr = np.asarray(accs, np.float64)
    b.record(f"{prefix}/agg_mean", f"{arr.mean():.4f}",
             fidelity={"accuracy_mean": float(arr.mean()),
                       "experiments": len(logs)})
    b.record(f"{prefix}/agg_std", f"{arr.std():.4f}",
             fidelity={"accuracy_std": float(arr.std()),
                       "accuracy_min": float(arr.min()),
                       "accuracy_max": float(arr.max())})
    return accs


def knobs_dict(resolved) -> Dict:
    """The knobs a round engine ran with (a runner's ``resolved_knobs``):
    chunk, engine, codec spec and where they came from."""
    return {"chunk": resolved.chunk, "engine": resolved.engine,
            "compress": str(resolved.compress), "source": resolved.source}


def launches() -> Dict[str, int]:
    """Every kernel's launch count so far (0 on the CPU, where the
    wrappers run their plain versions)."""
    from ..kernels import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def synchronize(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory_bytes(device) -> Optional[int]:
    """The card's peak allocated bytes since the last reset (None on the
    CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device)


def reset_peak_memory(device) -> None:
    """Start a new peak-memory window on the card."""
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


class CollectiveBytes:
    """The bytes of every collective made while it is on (a ``with``
    block): ``all_reduce`` and ``broadcast`` of ``torch.distributed`` and
    the two primitives of :mod:`repro_torch.collectives`, through which
    the port's engines gather and reduce-scatter, each call counted by the
    largest tensor it is given (a gather's output, a reduce-scatter's
    input).  ``records`` holds ``(stage, call, bytes)``, the stage the one
    :meth:`stage` runs at the time (a ``stage`` hook of the engines), and
    ``total`` their bytes."""

    CALLS = ((dist, "all_reduce"), (dist, "broadcast"),
             (collectives, "all_gather_into"),
             (collectives, "reduce_scatter_into"))

    def __init__(self):
        self.records: list = []
        self.stage_name: Optional[str] = None
        self._saved: list = []

    @property
    def total(self) -> int:
        return sum(b for _, _, b in self.records)

    def stage(self, name: str, fn):
        """Run ``fn`` with its collectives counted under ``name``."""
        self.stage_name = name
        try:
            return fn()
        finally:
            self.stage_name = None

    def __enter__(self):
        for module, name in self.CALLS:
            f = getattr(module, name)
            self._saved.append((module, name, f))
            setattr(module, name, self._wrap(name, f))
        return self

    def __exit__(self, *exc):
        for module, name, f in self._saved:
            setattr(module, name, f)
        self._saved.clear()

    def _wrap(self, name, f):
        def call(*args, **kw):
            sizes = [a.numel() * a.element_size() for a in args
                     if isinstance(a, torch.Tensor)]
            self.records.append((self.stage_name, name, max(sizes)))
            return f(*args, **kw)
        return call
