"""Gradient compression: int8 quantization with error feedback (EF-SGD).

Port of ``repro/optim/compression.py``.  ``apply_ef`` compresses one
gradient tensor and carries the quantization residual in an error-feedback
buffer, so the sum of the injected noise stays bounded; ``compress_tree``
applies it leaf by leaf.  ``compressed_psum`` replaces the all-reduce over
a process group (the slow cross-pod axis) with an int8 payload.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map


def quantize(x):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    s = torch.clamp_min(torch.amax(torch.abs(x)) / 127.0, 1e-20)
    return torch.round(x / s).to(torch.int8), s


def dequantize(q, s):
    return q.to(torch.float32) * s


def apply_ef(g, ef):
    """Error-feedback compression of one gradient tensor: returns
    (g + ef quantized and dequantized, the new residual)."""
    x = g.to(torch.float32) + ef
    d = dequantize(*quantize(x))
    return d, x - d


def compress_tree(grads, ef_state):
    out = tree_map(apply_ef, grads, ef_state)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(x, group=None):
    """int8-payload all-reduce over ``group`` (None: the default group),
    averaged over its ranks.

    Quantizes locally, takes the largest scale over the ranks,
    re-quantizes against it so the sum is exact in int32, reduces the
    int32-widened codes and dequantizes with that scale: the reference's
    operations in its order.  (On a real link the payload is the int8
    tensor.)
    """
    _, s = quantize(x)
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    total = torch.round(x / s_max).to(torch.int8).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    # a 0-dim tensor on x's device: a host scalar divisor would be a
    # reciprocal multiply on the card
    n = torch.full((), dist.get_world_size(group), dtype=torch.float32,
                   device=x.device)
    return total.to(torch.float32) * s_max / n
