"""DBSCAN workload discovery (Algorithm 2, discovery step).

Port of ``repro/core/dbscan.py``.  Two paths share one semantics:

* **fast** (default) — ``kernels.pairdist.neighbor_adjacency`` gives
  per-row ε-neighbour counts and the bit-packed adjacency (the CUDA kernel
  on the card, its plain version on the CPU); labels then converge by
  min-label propagation with **pointer jumping**, so the number of
  neighbour sweeps is O(log N).  Each sweep reads the packed adjacency
  strip by strip, so no (N, N) tensor is built, and costs one host sync
  for its convergence test.
* **ref** — the seed formulation: dense (N, N) distance matrix and one-hop
  propagation.  Kept as the parity oracle.

Both yield identical labels: core points take the minimum index of their
core-connected component, border points adopt the smallest core-neighbour
label, noise is -1, and clusters are renumbered 0..k-1 in root order.
``kmeans`` (the Fig-10 baseline, off the main path) is queued in ROADMAP.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.pairdist import (neighbor_adjacency, ref_pairdist,
                                          unpack_bits)

# elements of one unpacked adjacency strip (rows x Npad); strips are a
# multiple of the kernel's block rows
_STRIP_ELEMS = 1 << 22


def _dbscan_core(d2, eps_sq: float, min_pts: int):
    """One-hop min-label propagation over the dense adjacency matrix —
    O(diameter) sweeps of O(N²); the oracle the fast path is tested
    against."""
    n = d2.shape[0]
    adj = d2 <= eps_sq                                    # ε-neighbourhood
    n_nbr = torch.sum(adj, dim=1)                         # includes self
    core = n_nbr >= min_pts
    cc = adj & core[:, None] & core[None, :]              # core-core edges
    cc |= torch.eye(n, dtype=torch.bool, device=d2.device)
    idx = torch.arange(n, device=d2.device)
    lab = torch.where(core, idx, n)                       # n = +inf sentinel
    while True:
        nbr_min = torch.where(cc, lab[None, :], n).amin(dim=1)
        new = torch.minimum(lab, nbr_min)
        if torch.equal(new, lab):
            break
        lab = new
    border = torch.where(adj & core[None, :], lab[None, :], n).amin(dim=1)
    return torch.where(core, lab, torch.where(border < n, border, -1))


def _min_core_neighbor(lab_ext, packed, rows: int):
    """Per-row min of ``lab_ext`` over set adjacency bits, one strip of
    ``rows`` rows at a time (``lab_ext`` carries the sentinel Npad at
    non-core columns)."""
    np_ = packed.shape[0]
    out = torch.empty_like(lab_ext)
    for r0 in range(0, np_, rows):
        bits = unpack_bits(packed[r0:r0 + rows])          # (rows, Npad)
        out[r0:r0 + rows] = torch.where(bits, lab_ext[None, :], np_).amin(1)
    return out


def _compress(lab):
    """``lab = min(lab, lab[lab])`` to a fixed point: every sweep at least
    halves each label chain."""
    while True:
        new = torch.minimum(lab, lab[lab])
        if torch.equal(new, lab):
            return lab
        lab = new


def _dbscan_core_packed(counts, packed, min_pts: int, n: int, block: int):
    """DBSCAN labels (Npad,) from the neighbour kernel's outputs, by
    pointer-jumping propagation."""
    np_ = packed.shape[0]
    bm = min(block, np_)
    rows = bm * max(1, _STRIP_ELEMS // (bm * np_))
    idx = torch.arange(np_, device=packed.device)
    core = (counts >= min_pts) & (idx < n)                # padding: never core
    lab = idx
    while True:
        nbr = _min_core_neighbor(torch.where(core, lab, np_), packed, rows)
        new = _compress(torch.where(core, torch.minimum(lab, nbr), lab))
        if torch.equal(new, lab):
            break
        lab = new
    border = _min_core_neighbor(torch.where(core, lab, np_), packed, rows)
    return torch.where(core, lab, torch.where(border < np_, border, -1))


def _relabel(raw: np.ndarray) -> np.ndarray:
    """Renumber cluster roots to 0..k-1 (ascending root order), noise = -1."""
    uniq, inv = np.unique(raw, return_inverse=True)
    out = inv.astype(np.int64)
    if uniq.size and uniq[0] < 0:
        out -= 1
    return out


def labels_from_adjacency(counts, packed, n: int, min_pts: int,
                          block: int = 128) -> np.ndarray:
    """Relabelled DBSCAN labels (N,) from neighbour counts and packed
    adjacency, whichever implementation produced them."""
    block = max(8, block - block % 8)
    raw = _dbscan_core_packed(counts, packed, int(min_pts), n, block)[:n]
    return _relabel(raw.cpu().numpy())


def _as_points(x, device):
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else dispatch.resolve_device(device)
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=dispatch.resolve_device(device))


def dbscan(x, eps: float, min_pts: int = 5, impl: str = "auto",
           block: int = 128, *, device=None) -> np.ndarray:
    """x: (N, F) -> labels (N,) int, noise = -1, clusters renumbered 0..k-1.

    ``device``: where to run; None means the tensor's own device, or CUDA
    for array input.  ``impl``: "auto" takes the streaming path (the CUDA
    kernel on the card, its plain version on the CPU); "ref" is the dense
    one-hop oracle (see ``kernels/dispatch.py``).
    """
    x = _as_points(x, device)
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    block = max(8, block - block % 8)   # match the kernel's bit-pack rounding
    if dispatch.resolve(impl, x.device) == "ref":
        eps_sq = float(np.float32(eps * eps))
        raw = _dbscan_core(ref_pairdist(x), eps_sq, int(min_pts))
        return _relabel(raw.cpu().numpy())
    counts, packed = neighbor_adjacency(x, eps, block=block, impl=impl)
    return labels_from_adjacency(counts, packed, n, min_pts, block)


def agglomerative_single_link(x, dist_thresh: float, impl: str = "auto",
                              *, device=None) -> np.ndarray:
    """Single-linkage connected components at a distance threshold — DBSCAN
    with ``min_pts=1`` (every point is core, there is no noise)."""
    return dbscan(x, eps=float(dist_thresh), min_pts=1, impl=impl,
                  device=device)
