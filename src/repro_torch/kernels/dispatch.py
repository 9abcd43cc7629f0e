"""Device resolution and kernel-implementation dispatch.

Counterpart of ``repro/kernels/dispatch.py``.  There the JAX backend picks
the strategy; here the device of the tensor does:

* ``"auto"``, ``"fast"``, ``"pallas"`` — a CUDA tensor launches the
  hand-written kernel (``"cuda"``), a CPU tensor takes the kernel's plain
  PyTorch version (``"plain"``).
* ``"xla"``, ``"pallas_interpret"`` — the reference's CPU strategies.  They
  map to the plain version on the CPU and are refused on the card, where
  the kernel is the only path.
* ``"ref"`` — the dense oracle; never chosen implicitly.
* ``"legacy"``, ``"seed"`` — the reference's frozen seed paths, which the
  port does not carry yet (ROADMAP queue A, "legacy/seed paths").

Entry points take ``device=None`` to mean CUDA, and raise when CUDA is
missing: nothing falls back to the CPU unless the caller asks for it.
"""
from __future__ import annotations

import torch

IMPLS = ("auto", "fast", "pallas", "pallas_interpret", "xla", "ref",
         "legacy", "seed")

_KERNEL = ("auto", "fast", "pallas")
_CPU_ONLY = ("xla", "pallas_interpret")


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without a usable card raises —
    pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def resolve(impl: str | None, device) -> str:
    """Map a requested implementation on ``device`` to ``"cuda"`` (the
    hand-written kernel), ``"plain"`` (its PyTorch version) or ``"ref"``
    (the dense oracle)."""
    impl = "auto" if impl is None else impl
    dev = torch.device(device)
    if impl in ("legacy", "seed"):
        raise NotImplementedError(
            f"impl={impl!r} selects the reference's frozen seed path, which "
            "the port does not carry yet (ROADMAP queue A: legacy/seed paths)")
    if impl == "ref":
        return "ref"
    if impl in _KERNEL:
        return "cuda" if dev.type == "cuda" else "plain"
    if impl in _CPU_ONLY:
        if dev.type == "cuda":
            raise ValueError(
                f"impl={impl!r} names a CPU strategy; on the card the "
                "hand-written kernel is the only path (use 'auto')")
        return "plain"
    raise ValueError(f"unknown kernel impl {impl!r}; expected one of {IMPLS}")
