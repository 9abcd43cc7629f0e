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
* ``"legacy"``, ``"seed"`` — the reference's frozen seed paths.  There
  they mean interpret-mode Pallas, a CPU strategy; here they resolve like
  ``"auto"``: a CUDA tensor launches the hand-written kernel (for the seed
  DBSCAN path, the dense ``pairdist`` kernel), a CPU tensor takes its
  plain version.

A kernel's CUDA wrapper refuses fake tensors (``refuse_fake``).

Entry points take ``device=None`` to mean CUDA, and raise when CUDA is
missing: nothing falls back to the CPU unless the caller asks for it.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

IMPLS = ("auto", "fast", "pallas", "pallas_interpret", "xla", "ref",
         "legacy", "seed")

_KERNEL = ("auto", "fast", "pallas", "legacy", "seed")
_CPU_ONLY = ("xla", "pallas_interpret")


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without a usable card raises —
    pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def refuse_fake(*tensors) -> None:
    """Raise on a fake tensor (``FakeTensorMode``, as the dry run makes):
    it has no memory, and its data pointer is 0, so a kernel launched on
    it would read and write through null pointers."""
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError("a CUDA kernel cannot run on fake tensors; the "
                           "dry run makes them on the CPU, where each "
                           "kernel takes its plain version")


def resolve(impl: str | None, device) -> str:
    """Map a requested implementation on ``device`` to ``"cuda"`` (the
    hand-written kernel), ``"plain"`` (its PyTorch version) or ``"ref"``
    (the dense oracle)."""
    impl = "auto" if impl is None else impl
    dev = torch.device(device)
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


def takes_kernels(attn_impl: str | None) -> bool:
    """Whether the models send flash, the SSD scan and the SSM decode step
    to their kernels (then ``resolve``d by device) under the ``attn_impl``
    tunable: on ``"pallas"`` alone, as the reference's models do; so
    ``"auto"`` keeps their plain path (ROADMAP G)."""
    return attn_impl == "pallas"
