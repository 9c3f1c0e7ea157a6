"""Dense-state network model for the round engine — the port of
``repro.netsim.dense.DenseNetwork`` (DESIGN.md §9).

One engine round is one virtual time slot of ``round_s`` seconds: fast
nodes complete one local round a slot, a straggler with compute
multiplier ``c`` one every ``c`` slots, a churned-out node none (its
parameters freeze until it rejoins).

**Staleness.** An edge whose delay (base latency + keyed jitter +
serialization of the wire payload) fits inside one slot delivers fresh
parameters; a longer one delivers from ``s = floor(delay / round_s)``
rounds back, out of a ring of the last ``S`` post-step snapshots the
engine carries.  ``S`` (:meth:`DenseNetwork.depth`) is the largest
reachable staleness plus one, capped by ``max_staleness``.

**Drops.** Bernoulli loss, partition windows and down endpoints remove
the edge from the round's delivery; uniform strategies renormalize over
what arrived, fixed-W strategies fold the missing mass into self-weight.

The draws are keyed by ``(profile.seed, round, stream)``
(:mod:`.sampling`) and the fault timeline is a host numpy array from its
seed, so a trajectory does not depend on chunk boundaries.  The division
``delay / round_s`` is by an f32 tensor on the delay's device: PyTorch's
CUDA division by a host number multiplies by its reciprocal, which moves
a delay at a slot boundary into the other slot.

:class:`SweepNetwork` stacks one :class:`DenseNetwork` per experiment for
the sweep engine (:class:`repro_torch.dlrt.SweepSuperstep`).
"""
from __future__ import annotations

import copy
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import sampling
from .faults import FaultModel
from .transport import NetworkProfile


class NetDraws(NamedTuple):
    """One round's network uniforms, ``[n, n]`` f32 each, or ``None``
    where the profile draws nothing (no jitter, no loss)."""
    jitter_u: Optional[torch.Tensor]    # stream STREAM_JITTER
    drop_u: Optional[torch.Tensor]      # stream STREAM_DROP_MODEL


class DenseNetwork:
    """The network model the round engine threads through every round
    (``RunnerConfig.net``).

    ``profile`` — the :class:`NetworkProfile`; ``round_s`` — virtual
    seconds per round; ``faults`` — an optional :class:`FaultModel` for
    churn and stragglers; ``max_staleness`` — the ring's depth cap (delays
    past it clamp to the oldest snapshot).
    """

    def __init__(self, profile: NetworkProfile, *, round_s: float = 1.0,
                 faults: Optional[FaultModel] = None,
                 max_staleness: int = 8):
        if round_s <= 0.0:
            raise ValueError("round_s must be positive")
        if max_staleness < 1:
            raise ValueError("max_staleness must be >= 1")
        self.profile = profile
        self.round_s = float(round_s)
        self.faults = faults
        self.max_staleness = int(max_staleness)

    def depth(self, model_bytes: int) -> int:
        """Ring depth ``S``: 1 + the largest reachable staleness of a
        ``model_bytes`` payload, capped at ``max_staleness``."""
        p = self.profile
        worst = p.base_latency_s + p.jitter_s \
            + p.transfer_seconds(model_bytes)
        return 1 + min(self.max_staleness - 1,
                       int(math.floor(worst / self.round_s)))

    def draws(self, rnd: int, n: int, device="cuda") -> NetDraws:
        """Round ``rnd``'s keyed uniforms on ``device``."""
        dev = resolve_device(device)
        p = self.profile
        jit = sampling.uniform(p.seed, rnd, n, sampling.STREAM_JITTER, dev) \
            if p.jitter_s > 0.0 else None
        drop = sampling.uniform(p.seed, rnd, n, sampling.STREAM_DROP_MODEL,
                                dev) if p.drop_rate > 0.0 else None
        return NetDraws(jit, drop)

    def staleness_matrix(self, rnd: int, n: int, model_bytes: int,
                         depth: int, *, draws: Optional[NetDraws] = None,
                         device="cuda") -> torch.Tensor:
        """``[n, n]`` int32: how many rounds back edge j -> i delivers from
        this round (0 = fresh; clamped to ``depth - 1``; 0 on the
        diagonal).  ``draws`` replaces the keyed draw."""
        dev = resolve_device(device)
        u = None if draws is None else draws.jitter_u
        lat = sampling.latency_matrix(self.profile, rnd, n, model_bytes,
                                      dev, u)
        slot = torch.tensor(np.float32(self.round_s), device=dev)
        s = torch.floor(lat / slot).to(torch.int32)
        s = s.clamp(0, depth - 1)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        return torch.where(eye, torch.zeros_like(s), s)

    def drop_mask(self, rnd: int, n: int, *,
                  draws: Optional[NetDraws] = None,
                  device="cuda") -> torch.Tensor:
        """``[n, n]`` bool: edges the network eats this round (Bernoulli
        loss + partition windows at the round's f32 start time; endpoint
        liveness is separate).  ``draws`` replaces the keyed draw."""
        dev = resolve_device(device)
        u = None if draws is None else draws.drop_u
        lost = sampling.drop_matrix(self.profile, rnd, n, dev,
                                    sampling.STREAM_DROP_MODEL, u)
        if self.profile.partitions:
            t = sampling.round_time(rnd, self.round_s)
            lost = lost | sampling.partition_matrix(self.profile, t, n, dev)
        return lost

    def round_masks(self, rounds: int, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(up [rounds, n], step [rounds, n])`` bool numpy arrays from
        the seeded fault timeline, all True without faults."""
        if self.faults is None:
            ones = np.ones((rounds, n), bool)
            return ones, ones
        if self.faults.n != n:
            raise ValueError(f"fault model covers {self.faults.n} nodes, "
                             f"engine has {n}")
        up = self.faults.round_up_masks(rounds, self.round_s)
        return up, self.faults.round_step_masks(rounds, self.round_s,
                                                up=up)


class SweepNetwork:
    """Per-experiment stack of :class:`DenseNetwork` models for the sweep
    engine (:class:`repro_torch.dlrt.SweepSuperstep`) — the port of
    ``repro.netsim.dense.SweepNetwork``.

    Each experiment keeps its profile's scalars (seed, fixed latency,
    jitter, drop rate) and its fault timeline; a round's matrices for all
    experiments come from the folded draws
    (:func:`~.sampling.jitter_matrix_folded`,
    :func:`~.sampling.drop_matrix_folded`) with the same operations per
    element as :meth:`DenseNetwork.staleness_matrix` and
    :meth:`DenseNetwork.drop_mask`, so experiment ``e`` sees the bits its
    own :class:`DenseNetwork` gives a solo run.  The snapshot ring is
    shared, ``max_e depth_e`` deep (:meth:`depth`), and each experiment's
    staleness clamps to its own ``depth_e - 1`` (:meth:`depths`).
    Partition windows are refused (the reference's sweep cannot vmap their
    group structure), and all experiments share ``round_s`` (one round is
    one shared virtual slot).
    """

    def __init__(self, nets: Sequence[DenseNetwork]):
        nets = list(nets)
        if not nets:
            raise ValueError("SweepNetwork needs at least one DenseNetwork")
        round_s = {net.round_s for net in nets}
        if len(round_s) != 1:
            raise ValueError(f"all experiments must share round_s "
                             f"(got {sorted(round_s)}) — one scan round "
                             "is one shared virtual time slot")
        for e, net in enumerate(nets):
            if net.profile.partitions:
                raise ValueError(
                    f"experiment {e}: profile {net.profile.name!r} has "
                    "partition windows — static group structure cannot "
                    "be vmapped over the experiment axis; run it as a "
                    "single-experiment DenseNetwork")
        self.nets = nets
        self.round_s = nets[0].round_s

    def __len__(self) -> int:
        return len(self.nets)

    def experiments(self, lo: int, hi: int) -> "SweepNetwork":
        """Experiments ``[lo, hi)`` as a stack of their own, of this
        class (a subclass's draws kept): what a rank of the sweep's
        ``exp`` axis draws.  Its :meth:`depth` is theirs, not the whole
        stack's."""
        out = copy.copy(self)
        out.nets = self.nets[lo:hi]
        return out

    def depth(self, model_bytes: int) -> int:
        """The shared ring's depth: the deepest experiment's
        :meth:`DenseNetwork.depth`."""
        return max(net.depth(model_bytes) for net in self.nets)

    def depths(self, model_bytes: int) -> np.ndarray:
        """``[E]`` int32: each experiment's own depth; its staleness
        clamps to ``depths[e] - 1``."""
        return np.asarray([net.depth(model_bytes) for net in self.nets],
                          np.int32)

    def profile_arrays(self, model_bytes: int):
        """``(seed int64, fixed_s f32, jitter_s f32, drop_rate f32)``, each
        ``[E]``; ``fixed_s`` is base latency plus serialization folded to
        one f32, as :func:`~.sampling.latency_matrix` folds it."""
        seeds = np.asarray([net.profile.seed for net in self.nets],
                           np.int64)
        fixed = np.asarray([np.float32(net.profile.base_latency_s
                                       + net.profile.transfer_seconds(
                                           model_bytes))
                            for net in self.nets], np.float32)
        jit = np.asarray([net.profile.jitter_s for net in self.nets],
                         np.float32)
        drop = np.asarray([net.profile.drop_rate for net in self.nets],
                          np.float32)
        return seeds, fixed, jit, drop

    def round_masks(self, rounds: int, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(up [E, rounds, n], step [E, rounds, n])`` bool stacks of each
        experiment's fault timeline."""
        ups, steps = zip(*(net.round_masks(rounds, n) for net in self.nets))
        return np.stack(ups), np.stack(steps)

    def draws(self, rnd: int, n: int, device="cuda") -> List[NetDraws]:
        """Round ``rnd``'s uniforms of every experiment, both streams
        always drawn (the folded draws), on the CPU generator keyed by
        each profile's seed, then moved to ``device``."""
        dev = resolve_device(device)
        return [NetDraws(*(sampling.uniform(net.profile.seed, rnd, n,
                                            stream, dev)
                           for stream in (sampling.STREAM_JITTER,
                                          sampling.STREAM_DROP_MODEL)))
                for net in self.nets]

    def round_matrices(self, rnd: int, n: int, model_bytes: int, *,
                       draws: Optional[Sequence[NetDraws]] = None,
                       device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
        """``(staleness [E, n, n] int32, dropped [E, n, n] bool)``: each
        experiment's :meth:`DenseNetwork.staleness_matrix` (clamped to its
        own depth) and :meth:`DenseNetwork.drop_mask`, from the folded
        draws (``draws``, one :class:`NetDraws` an experiment, replaces
        :meth:`draws`)."""
        dev = resolve_device(device)
        if draws is None:
            draws = self.draws(rnd, n, dev)
        _, fixed, jit, drop = self.profile_arrays(model_bytes)
        col = lambda a: torch.as_tensor(a, device=dev)[:, None, None]
        u_jit = torch.stack([d.jitter_u.to(dev) for d in draws])
        u_drop = torch.stack([d.drop_u.to(dev) for d in draws])
        lat = col(fixed) + sampling.jitter_matrix_folded(
            None, rnd, n, col(jit), dev, u=u_jit)
        slot = torch.tensor(np.float32(self.round_s), device=dev)
        s = torch.floor(lat / slot).to(torch.int32)
        s = torch.minimum(s.clamp_min(0), col(self.depths(model_bytes)) - 1)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        stal = torch.where(eye, torch.zeros_like(s), s)
        lost = sampling.drop_matrix_folded(None, rnd, n, col(drop), dev,
                                           u=u_drop)
        return stal, lost
