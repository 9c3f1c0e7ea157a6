"""``"auto"`` knob resolution for :class:`repro_torch.dlrt.RunnerConfig` —
the port of ``repro.tune.resolve``.

``DecentralizedRunner._make_engine`` calls :func:`resolve_knobs` before
the round engine is built.  Resolution is a pure function of ``(cfg,
params, cache file contents)`` — no timing — so an ``"auto"`` run is
bit for bit a run given the resolved values explicitly.  The port's
knobs are ``chunk``, ``engine``, ``compress`` and ``collective``; the
reference's ``block_d`` has no counterpart (the card's kernels pick their
own tiles).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .cache import TuneEntry, TuneShape, TuningCache, load_default_cache

AUTO = "auto"


@dataclass(frozen=True)
class ResolvedKnobs:
    """Concrete knob values handed to the round engine, and where they
    came from: ``explicit`` (nothing was ``"auto"``), ``cache:<key>`` (the
    cache had the shape) or ``default:<key>`` (``"auto"`` asked, no entry:
    the hand-set defaults)."""
    chunk: Optional[int]
    source: str
    engine: str = "dense"
    # A codec spec string, or a CompressConfig passed through from an
    # explicit RunnerConfig; the engine parses it.
    compress: object = "none"
    # The sharded engine's mixing schedule (read only with a mesh).
    collective: str = "gather"


def mesh_world(cfg) -> int:
    """The node-axis shard count a configuration runs on: 1 without a
    mesh, ``cfg.mesh_devices`` with one (0: the initialised process
    group's world size, 1 without a group)."""
    if cfg.mesh_devices is None:
        return 1
    if cfg.mesh_devices:
        return cfg.mesh_devices
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def shape_of(cfg, params) -> TuneShape:
    """The :class:`TuneShape` of a runner configuration and its
    node-stacked parameters: the parameters' device type, the per-node
    flattened parameter count, the node mesh's world size
    (:func:`mesh_world`), and the network model's ring depth on the
    per-transfer payload."""
    from ..dlrt.runtime import stacked_model_bytes
    n = cfg.n_nodes
    leaves = list(params.values())
    d = sum(leaf.numel() // n for leaf in leaves)
    net = 0
    if cfg.net is not None:
        model_bytes = cfg.model_bytes or stacked_model_bytes(params, n)
        net = cfg.net.depth(model_bytes)
    return TuneShape(backend=leaves[0].device.type, n=n, d=d,
                     devices=mesh_world(cfg), net=net)


def resolve_knobs(cfg, params,
                  cache: Optional[TuningCache] = None) -> ResolvedKnobs:
    """Resolve ``cfg``'s knobs to concrete values.

    Knobs not set to ``"auto"`` pass through unchanged.  ``"auto"`` knobs
    take the cache entry's value for this run's shape, or the hand-set
    default (``TuneEntry()``'s field defaults) when the cache has none.
    """
    engine, compress = cfg.engine, cfg.compress
    autos = (cfg.chunk == AUTO, engine == AUTO, compress == AUTO,
             cfg.collective == AUTO)
    if not any(autos):
        return ResolvedKnobs(chunk=cfg.chunk, source="explicit",
                             engine=engine, compress=compress,
                             collective=cfg.collective)
    shape = shape_of(cfg, params)
    if cache is None:
        cache = load_default_cache()
    entry = cache.get(shape)
    source = (f"cache:{shape.key()}" if entry is not None
              else f"default:{shape.key()}")
    e = entry or TuneEntry()
    return ResolvedKnobs(
        chunk=e.chunk if autos[0] else cfg.chunk,
        source=source,
        engine=e.engine if autos[1] else engine,
        compress=e.compress if autos[2] else compress,
        collective=e.collective if autos[3] else cfg.collective)
