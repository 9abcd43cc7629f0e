"""Gradient compression: int8 quantization with error feedback (EF-SGD).

Port of ``repro/optim/compression.py``'s single-process building blocks:
``apply_ef`` compresses one gradient tensor and carries the quantization
residual in an error-feedback buffer, so the sum of the injected noise
stays bounded; ``compress_tree`` applies it leaf by leaf.  The reference's
``compressed_psum`` (the int8-payload all-reduce across pods) needs a
process group and comes with the distribution slice (ROADMAP queue A).
"""
from __future__ import annotations

import torch

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
