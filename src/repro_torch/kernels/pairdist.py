"""Tiled pairwise squared distances and the fused ε-neighbourhood kernel
(per-row neighbour counts + bit-packed adjacency).

Counterpart of ``repro/kernels/pairdist.py``.  KERMIT's workload discovery
runs DBSCAN over the window history at every analysis, and these are its
O(N²F) front ends:

* ``neighbor_adjacency`` — the streaming fast path.  On a CUDA tensor it
  launches the hand-written kernel ``csrc/nbr_adjacency.cu`` (which
  replaces the TPU kernel ``_nbr_kernel``); on a CPU tensor it takes the
  plain version ``_neighbor_adjacency_plain``, the counterpart of the
  reference's XLA twin: same blocking, thresholding and bit packing, one
  (bm, Npad) strip at a time.  No (N, N) float32 matrix.
* ``pairdist`` — the dense (N, N) float32 matrix of the seed (legacy)
  DBSCAN path.  On a CUDA tensor it launches ``csrc/pairdist.cu`` (which
  replaces the TPU kernel ``_kernel``); on a CPU tensor it takes the plain
  version ``_pairdist_plain``.  Both compute each entry with the
  arithmetic of their streaming counterpart, so ``pairdist(x) <= ε²`` is
  the adjacency ``neighbor_adjacency`` packs, bit for bit, on either
  device.
* ``ref_*`` — dense oracles.

Bit layout: adjacency column j lives in byte j // 8, bit j % 8 (LSB
first).  ``_pack_bits``/``unpack_bits`` are the single source of truth for
it on the PyTorch side; the CUDA kernel writes the same layout from the
bits its threads threshold.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import cuda_build, dispatch

# launches of the CUDA kernels (``LAUNCHES``: nbr_adjacency.cu,
# ``DENSE_LAUNCHES``: pairdist.cu); each wrapper adds one per launch and
# nothing else touches them except callers resetting them to 0
LAUNCHES = 0
DENSE_LAUNCHES = 0


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


_FP = (16, 32, 64)     # feature widths the kernels are instantiated for


# -- dense pairdist (the seed DBSCAN path) ------------------------------------


def _pairdist_plain(x, *, block: int = 128):
    """Plain PyTorch version of the dense kernel: the reference's tile grid
    (``bm = min(block, N)``, N zero-padded to a multiple of bm, the result
    cut to (N, N)), walked one (bm, Npad) strip of tiles at a time.  Each
    entry is ``max(xx + yyᵀ - 2·xy, 0)`` in float32 with the streaming plain
    version's operations, so its ε-threshold is that version's adjacency."""
    n, f = x.shape
    x = x.to(torch.float32)
    if n == 0:
        return x.new_zeros((0, 0))
    bm = min(block, n)
    npad = (-n) % bm
    if npad:
        x = torch.cat([x, x.new_zeros((npad, f))])
    np_ = x.shape[0]
    yy = torch.sum(x * x, dim=1)
    out = torch.empty((np_, np_), dtype=torch.float32, device=x.device)
    for r0 in range(0, np_, bm):
        xb = x[r0:r0 + bm]
        xx = torch.sum(xb * xb, dim=1, keepdim=True)
        out[r0:r0 + bm] = torch.clamp_min(xx + yy[None, :] - 2.0 * (xb @ x.T),
                                          0.0)
    return out[:n, :n]


# pairdist(x, n, fp, out, stream)
_DENSE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]


def _pairdist_cuda(x):
    """Launch ``csrc/pairdist.cu`` on the current stream.  Any float dtype
    is cast to float32, as the TPU kernel casts its tiles.  The kernel's
    own 64 × 128 tiles give the entries any tile grid gives."""
    global DENSE_LAUNCHES
    dispatch.refuse_fake(x)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    if x.dim() != 2 or not x.is_floating_point():
        raise ValueError(f"expected float x of shape (N, F), got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, f = x.shape
    fp = next((w for w in _FP if f <= w), None)
    if fp is None or f == 0:
        raise ValueError(f"the CUDA kernel takes 1 <= F <= {_FP[-1]}, got {f}")
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    if (f != fp or x.dtype != torch.float32 or not x.is_contiguous()
            or x.data_ptr() % 16):
        xp = torch.zeros((n, fp), dtype=torch.float32, device=x.device)
        xp[:, :f] = x
        x = xp
    fn = cuda_build.function("pairdist", "pairdist", _DENSE_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), n, fp, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairdist launch failed: CUDA error {err}")
    DENSE_LAUNCHES += 1
    return out


def pairdist(x, *, block: int = 128, impl: str = "legacy"):
    """(N, F) -> (N, N) float32 squared distances: the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor (``impl`` is checked
    against the device by ``dispatch.resolve``)."""
    if dispatch.resolve(impl, x.device) == "cuda":
        return _pairdist_cuda(x)
    return _pairdist_plain(x, block=block)


# -- fused streaming ε-neighbourhood kernel -----------------------------------


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


# nbr_adjacency(x, n, npad, fp, eps_sq, counts, packed, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


def _neighbor_adjacency_cuda(x, *, eps_sq: float, block: int):
    """Launch ``csrc/nbr_adjacency.cu`` on the current stream.  Outputs have
    exactly the reference's Npad and width."""
    global LAUNCHES
    dispatch.refuse_fake(x)
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
    fn = cuda_build.function("nbr_adjacency", "nbr_adjacency", _ARGTYPES)
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
