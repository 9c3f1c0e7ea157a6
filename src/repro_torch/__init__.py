"""PyTorch/CUDA port of the Morph reproduction (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s subpackages so that every function has an
obvious counterpart, and is held against it by the ``tests/test_torch_*``
parity tests.  It imports ``torch`` and numpy only.

Entry points (:class:`repro_torch.dlrt.DecentralizedRunner`, whose
``RunnerConfig.engine`` picks the dense or the sparse (CSR) engine; the
dense in-graph strategies in :mod:`repro_torch.core`; the sparse-native
:class:`repro_torch.sparse.SparseMorphStrategy` and
:class:`repro_torch.sparse.SparseEpidemicStrategy`;
:class:`repro_torch.data.DeviceDataStream`) run on the card by default
(``device="cuda"``) and raise on a host without one unless the caller
passes ``device="cpu"``.  CUDA tensors go through the hand-written
kernels in :mod:`repro_torch.kernels`; CPU tensors through their plain
PyTorch versions.
"""
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA on a
    host without a usable card (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")
    return dev


def fold_seed(seed: int, counter: int) -> int:
    """A ``torch.Generator`` seed that is a pure function of ``(seed,
    counter)`` — the port's stand-in for ``jax.random.fold_in(key,
    counter)``: draws keyed this way do not depend on what was drawn
    before (a round's batch or graph is the same whichever rounds ran)."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(counter) & 0xFFFFFFFF)
