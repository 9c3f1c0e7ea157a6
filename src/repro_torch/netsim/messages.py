"""Network envelopes for the event-driven runtime (DESIGN.md §5) — a copy
of ``repro.netsim.messages``.

The *protocol* message objects (ConnectRequest / ConnectAccept /
ConnectReject / GossipDigest) live in ``repro_torch.core.protocol`` —
they are runtime-agnostic.  This module adds the transport-level envelope
(:class:`Packet`) and the one payload only the network layer knows
about: :class:`ModelTransfer`, a model copy with its staleness
provenance and piggybacked gossip digest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

# Size charged to small control-plane messages (requests/accepts/rejects):
# a few ints + one float, padded to a realistic header.
CTRL_BYTES = 64


@dataclass(frozen=True)
class Packet:
    """One message in flight: protocol payload + network envelope."""
    src: int
    dst: int
    kind: str            # "request" | "accept" | "reject" | "model" | ...
    payload: Any
    size_bytes: int
    sent_at: float
    deliver_at: float


@dataclass(frozen=True)
class ModelTransfer:
    """A model copy travelling sender → receiver.

    ``snapshot`` is the sender's parameter row copied at *send* time (host
    numpy leaves) — by the time it arrives the sender may have moved on,
    which is exactly the staleness the metrics histogram records.
    ``digest`` is the sender's gossip digest, also snapshotted at send
    time (``None`` for strategies without a gossip plane)."""
    sender: int
    receiver: int
    receiver_round: int      # the round the receiver is pulling for
    sender_round: int        # sender's last completed local round at send
    snapshot: Any
    digest: Optional[Any] = None
