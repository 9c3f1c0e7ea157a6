"""PyTorch/CUDA port of the Morph reproduction (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s subpackages so that every function has an
obvious counterpart, and is held against it by the ``tests/test_torch_*``
parity tests.  It imports ``torch`` and numpy only (and, for checkpoints,
``zstandard`` where it is installed).

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
    before (a round's batch or graph is the same whichever rounds ran).

    A CPU generator reads only the low 32 bits of its seed, so those
    depend on both inputs: the high half is the key (``seed``, its own
    high half folded in) and the low half ``counter`` XOR the key times an
    odd constant.  For a given key that is a bijection of ``counter``, so
    seed 0 gives the counter itself, and folding again, as in
    ``fold_seed(fold_seed(seed, rnd), stream)``, keeps all three."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = (s ^ ((s >> 32) * 0x85EBCA6B)) & 0xFFFFFFFF
    return (key << 32) | ((int(counter) ^ (key * 0x9E3779B9)) & 0xFFFFFFFF)
