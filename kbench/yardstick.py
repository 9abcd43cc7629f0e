"""Peaks, and the operations and bytes of a kernel call, from shapes
alone.

Copied from ``chip_smoke.py`` (``flash_bound``, ``ssd_bound``), so that
later changes to the program cannot move the yardstick.  A model's
operations per serve call are counted by its family's module in
``kbench/reference/`` (``call_flops``), with these.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet (700 W): dense bf16 in the tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def flash_bound(B, S, H, K, d, elem=2) -> dict:
    """Least time for causal attention at (B, S): each of q, k, v and out
    read or written once; 4·d flops per visible (query, key) pair and
    head, S(S+1)/2 visible pairs per sequence."""
    bytes_ = elem * B * S * d * (2 * H + 2 * K)
    flops = 4 * d * H * B * S * (S + 1) / 2
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "flops": flops, "bytes": bytes_}


def ssd_bound(B, S, H, P, G, N, Q, elem=2) -> dict:
    """Least time for the chunked scan: x, B, C (``elem`` bytes) and dt
    read once, y and the state (fp32) written once; per chunk 2·Q²·N
    flops per group for C·Bᵀ, Q(Q+1)/2·(2P + 3) per head for the masked
    scores times x, 4·Q·N·P per head for the state read and update,
    against the bf16 tensor-core peak."""
    nc = S // Q
    flops = B * nc * (G * 2 * Q * Q * N
                      + H * (Q * (Q + 1) / 2 * (2 * P + 3) + 4 * Q * N * P))
    bytes_ = (elem * (B * S * H * P + 2 * B * S * G * N) + 4 * B * S * H
              + 4 * H + 4 * B * S * H * P + 4 * B * H * N * P)
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "flops": flops, "bytes": bytes_}


def ssd_chunk(S: int, chunk: int) -> int:
    """The chunk the scan runs at S: capped at S, halved until it
    divides S (``models/mamba2.py``, ``kernels/ssd_scan.py``)."""
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q
