"""Public entry points of the hand-written kernels.

Port of ``repro/kernels/ops.py``.  Each takes a CUDA tensor to its CUDA
kernel and a CPU tensor to its plain PyTorch version (``kernels/dispatch``
for the implementation names).
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.pairdist import (neighbor_adjacency, neighbor_count,
                                          pairdist)
from repro_torch.kernels.ssd_scan import ssd

__all__ = ["flash_attention", "ssd", "pairdist", "neighbor_count",
           "neighbor_adjacency"]
