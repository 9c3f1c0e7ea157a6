"""Discrete-event loop with a virtual clock (DESIGN.md §5) — a copy of
``repro.netsim.events``.

Events are ordered by ``(time, phase, seq)``:

* ``time``  — virtual seconds;
* ``phase`` — causal pipeline position *within* one virtual instant.  A
  zero-latency network collapses a whole decentralized round into a
  single ``t``; phases keep compute → negotiate → send → deliver → mix in
  causal order there, which is what makes the async runner degenerate to
  the lockstep runner exactly (see ``tests/test_torch_async.py``);
* ``seq``   — FIFO tiebreak for determinism.

:meth:`EventLoop.pop_coalesced` pops *all* events sharing the earliest
``(time, phase, kind)``.  Handlers that receive such a batch can process
it vectorized (the async runner turns a batch of simultaneous compute
completions into one node-stacked local step).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass(order=True, frozen=True)
class Event:
    time: float
    phase: int
    seq: int
    kind: str = field(compare=False)
    payload: Any = field(compare=False, default=None)


class EventLoop:
    """Priority-queue event loop over virtual time."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.processed = 0

    # -- scheduling --------------------------------------------------------

    def schedule(self, delay: float, kind: str, payload: Any = None,
                 phase: int = 0) -> Event:
        return self.schedule_at(self.now + delay, kind, payload, phase)

    def schedule_at(self, time: float, kind: str, payload: Any = None,
                    phase: int = 0) -> Event:
        if time < self.now:
            raise ValueError(f"cannot schedule into the past "
                             f"({time} < {self.now})")
        ev = Event(time=float(time), phase=phase, seq=next(self._seq),
                   kind=kind, payload=payload)
        heapq.heappush(self._heap, ev)
        return ev

    # -- draining ----------------------------------------------------------

    def empty(self) -> bool:
        return not self._heap

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def pop(self) -> Event:
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        self.processed += 1
        return ev

    def pop_coalesced(self) -> List[Event]:
        """Pop every queued event sharing the earliest (time, phase, kind).

        The batch is returned in seq (schedule) order; the clock advances
        to the batch time."""
        first = self.pop()
        batch = [first]
        while self._heap:
            nxt = self._heap[0]
            if (nxt.time, nxt.phase, nxt.kind) != (first.time, first.phase,
                                                   first.kind):
                break
            batch.append(self.pop())
        return batch

    def run(self, handler: Callable[[List[Event]], None],
            until: Optional[float] = None,
            max_events: Optional[int] = None) -> None:
        """Drain the queue through ``handler`` (called per coalesced
        batch) until empty, past ``until`` virtual seconds, or
        ``max_events`` processed (runaway guard)."""
        budget = max_events if max_events is not None else float("inf")
        while self._heap and self.processed < budget:
            if until is not None and self._heap[0].time > until:
                break
            handler(self.pop_coalesced())
