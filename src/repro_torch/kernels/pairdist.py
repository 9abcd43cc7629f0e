"""The fused ε-neighbourhood kernel: per-row neighbour counts and the
bit-packed adjacency matrix, without an (N, N) float32 matrix.

Counterpart of ``repro/kernels/pairdist.py``.  KERMIT's workload discovery
runs DBSCAN over the window history at every analysis, and this is its
O(N²F) front end:

* ``neighbor_adjacency`` — on a CUDA tensor it launches the hand-written
  kernel ``csrc/nbr_adjacency.cu`` (which replaces the TPU kernel
  ``_nbr_kernel``); on a CPU tensor it takes the plain version
  ``_neighbor_adjacency_plain``, the counterpart of the reference's XLA
  twin: same blocking, thresholding and bit packing, one (bm, Npad) strip
  at a time.
* ``ref_*`` — dense oracles.

Bit layout: adjacency column j lives in byte j // 8, bit j % 8 (LSB
first).  ``_pack_bits``/``unpack_bits`` are the single source of truth for
it on the PyTorch side; the CUDA kernel writes the same layout from its
ballot words.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import cuda_build, dispatch

# launches of the CUDA kernel; the wrapper adds one per launch and nothing
# else touches it except callers resetting it to 0
LAUNCHES = 0


def ref_pairdist(x):
    """(N, F) -> (N, N) squared euclidean distances."""
    x = x.to(torch.float32)
    n2 = torch.sum(x * x, dim=1)
    d2 = n2[:, None] + n2[None, :] - 2.0 * (x @ x.T)
    return torch.clamp_min(d2, 0.0)


def _eps_sq(eps) -> float:
    """ε² as the reference forms it (Python double) and compares it
    (rounded to float32)."""
    return float(np.float32(float(eps) * float(eps)))


def ref_neighbor_count(x, eps):
    return torch.sum(ref_pairdist(x) <= _eps_sq(eps), dim=1)


def ref_adjacency(x, eps):
    """(N, F) -> (N, N) bool ε-neighbourhood matrix (oracle)."""
    return ref_pairdist(x) <= _eps_sq(eps)


def block_rows(n: int, block: int) -> int:
    """The reference's tile height: ``block`` capped at N rounded up to 8,
    rounded down to a multiple of 8 (at least 8)."""
    bm = min(block, max(8, -(-n // 8) * 8))
    return max(8, bm - bm % 8)


def _bit_positions(device):
    return torch.arange(8, dtype=torch.int32, device=device)


def _pack_bits(adj):
    """(..., K) bool with K % 8 == 0 -> (..., K // 8) uint8."""
    b = adj.reshape(adj.shape[:-1] + (adj.shape[-1] // 8, 8))
    return torch.sum(b.to(torch.int32) << _bit_positions(adj.device),
                     dim=-1).to(torch.uint8)


def unpack_bits(packed, n_cols: int | None = None):
    """(..., W) uint8 -> (..., 8 * W) bool; optionally trimmed to n_cols."""
    bits = (packed[..., None].to(torch.int32)
            >> _bit_positions(packed.device)) & 1
    out = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,)) != 0
    return out if n_cols is None else out[..., :n_cols]


def _neighbor_adjacency_plain(x, *, eps_sq: float, block: int):
    """Plain PyTorch version of the kernel, strip by strip: identical
    blocking, thresholding and packing to the reference's XLA twin.  Peak
    memory is one (bm, Npad) strip."""
    n, f = x.shape
    x = x.to(torch.float32)
    bm = block_rows(n, block)
    npad = (-n) % bm
    if npad:
        x = torch.cat([x, x.new_zeros((npad, f))])
    np_ = x.shape[0]
    yy = torch.sum(x * x, dim=1)
    col_ok = torch.arange(np_, device=x.device) < n
    counts = torch.empty(np_, dtype=torch.int32, device=x.device)
    packed = torch.empty((np_, np_ // 8), dtype=torch.uint8, device=x.device)
    for r0 in range(0, np_, bm):
        xb = x[r0:r0 + bm]
        xx = torch.sum(xb * xb, dim=1, keepdim=True)
        d2 = torch.clamp_min(xx + yy[None, :] - 2.0 * (xb @ x.T), 0.0)
        adj = (d2 <= eps_sq) & col_ok[None, :]
        counts[r0:r0 + bm] = torch.sum(adj, dim=1, dtype=torch.int32)
        packed[r0:r0 + bm] = _pack_bits(adj)
    return counts, packed


_FP = (16, 32, 64)     # feature widths the kernel is instantiated for


def _neighbor_adjacency_cuda(x, *, eps_sq: float, block: int):
    """Launch ``csrc/nbr_adjacency.cu`` on the current stream.  Outputs have
    exactly the reference's Npad and width."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"expected x of shape (N, F), got {tuple(x.shape)}")
    n, f = x.shape
    fp = next((w for w in _FP if f <= w), None)
    if fp is None or f == 0:
        raise ValueError(f"the CUDA kernel takes 1 <= F <= {_FP[-1]}, got {f}")
    if n >= 2 ** 31 // 8:
        raise ValueError(f"N = {n} is too large for the kernel's int indices")
    bm = block_rows(n, block)
    np_ = n + (-n) % bm
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros((0, 0), dtype=torch.uint8, device=x.device))
    if f != fp or not x.is_contiguous() or x.data_ptr() % 16:
        xp = torch.zeros((n, fp), dtype=torch.float32, device=x.device)
        xp[:, :f] = x
        x = xp
    counts = torch.empty(np_, dtype=torch.int32, device=x.device)
    packed = torch.empty((np_, np_ // 8), dtype=torch.uint8, device=x.device)
    fn = cuda_build.load("nbr_adjacency").nbr_adjacency
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), n, np_, fp, eps_sq, counts.data_ptr(),
                 packed.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nbr_adjacency launch failed: CUDA error {err}")
    LAUNCHES += 1
    return counts, packed


def neighbor_adjacency(x, eps, *, block: int = 128, impl: str = "auto"):
    """(N, F), ε -> (counts (Npad,) int32, packed (Npad, Npad/8) uint8).

    Per-row ε-neighbour counts (self included) and the bit-packed
    adjacency matrix, never materializing (N, N) float32.  Rows ≥ N are
    the reference's zero padding: their columns are masked, so no real row
    counts them, but their own rows hold the real points within ε of the
    origin, exactly as the reference computes them.  Callers slice ``[:N]``.
    """
    route = dispatch.resolve(impl, x.device)
    eps_sq = _eps_sq(eps)
    if route == "cuda":
        return _neighbor_adjacency_cuda(x, eps_sq=eps_sq, block=block)
    return _neighbor_adjacency_plain(x, eps_sq=eps_sq, block=block)


def neighbor_count(x, eps, *, block: int = 128, impl: str = "auto"):
    """(N, F), ε -> (N,) int32 neighbour counts (self included)."""
    counts, _ = neighbor_adjacency(x, eps, block=block, impl=impl)
    return counts[:x.shape[0]]
