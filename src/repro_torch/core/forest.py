"""Random forest (WorkloadClassifier / TransitionClassifier) in PyTorch.

Port of ``repro/core/forest.py``.  Level-wise greedy training of complete
binary trees with histogram splits on global quantile candidates, Gini
impurity, bootstrap rows and per-tree feature subsets, batched over trees
(the reference's ``vmap``).  Parameters are a dict of tensors
``{"feat": (T, M) int32, "thr": (T, M) float32, "dist": (T, 2^D, C)}``.

Every random draw of a fit (bootstrap rows, feature masks) comes from
``_forest_draws``; tests replace it with the reference's ``jax.random``
draws.  Where the reference's compiled arithmetic is bit-gated downstream
(quantile levels and interpolation, Gini impurity, tree averaging) the
port states the float32 operation sequence XLA runs — including its fused
multiply-adds, emulated exactly through float64 — so splits and
predictions come out identical.  The seed eager fit (``compiled=False``)
is not ported (ROADMAP queue A, legacy/seed paths).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

_F32 = np.float32


@dataclass(frozen=True)
class ForestConfig:
    n_trees: int = 32
    depth: int = 6                 # internal levels; leaves = 2^depth
    n_quantiles: int = 16
    n_classes: int = 8
    feature_frac: float = 0.7      # per-tree feature subset
    min_leaf: int = 2
    max_samples: int = 0           # bootstrap draws per tree; 0 = N (classic)


def _fma(a, b, c):
    """float32 fused multiply-add a*b + c with one rounding: the product of
    two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _quantile_levels(q: int) -> np.ndarray:
    """``jnp.linspace(0.02, 0.98, q)`` as XLA computes it in float32: the
    division by q-1 becomes a reciprocal multiply and the final add a fused
    multiply-add."""
    if q < 2:
        return np.full(q, 0.02, np.float32)
    div = q - 1
    it = np.arange(div, dtype=_F32)
    r = _F32(1) / _F32(div)
    left = _F32(0.02) * (_F32(1) - it * r)
    lev = (it.astype(np.float64) * np.float64(_F32(0.98) * r)
           + left.astype(np.float64)).astype(_F32)
    return np.append(lev, _F32(0.98))


def _quantile_grid(x, q: int):
    """(N, F) -> (F, Q) linear-interpolated quantiles at the levels above
    (``jnp.quantile``'s sequence: sort, q·(N-1), floor/ceil weights, then
    low·w_low + high·w_high as one fused multiply-add)."""
    n = x.shape[0]
    a = torch.sort(x, dim=0).values
    qq = torch.as_tensor(_quantile_levels(q), device=x.device) * float(n - 1)
    lo, hi = torch.floor(qq), torch.ceil(qq)
    hw = qq - lo
    lw = 1.0 - hw
    lo = lo.clamp(0, n - 1).long()
    hi = hi.clamp(0, n - 1).long()
    out = _fma(a[lo], lw[:, None], a[hi] * hw[:, None])     # (Q, F)
    return out.T.contiguous()


def _seq_sum(t, dim: int):
    """Sum along ``dim`` left to right, as XLA's reduction loop does."""
    parts = t.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _sum_sq(p):
    """Sum of squares over the last axis as XLA's fused reduction computes
    it: left to right from 0, each step one fused multiply-add."""
    acc = torch.zeros_like(p[..., 0])
    for q in p.unbind(-1):
        acc = _fma(q, q, acc)
    return acc


def _forest_draws(seed: int, n_trees: int, n: int, s: int, f: int,
                  feature_frac: float):
    """Every random draw of a forest fit: bootstrap rows (T, S) int64 in
    [0, n) and per-tree feature masks (T, F) bool with at least one feature
    on.  From a CPU generator seeded with ``seed``, so the CPU and the card
    draw the same numbers."""
    g = torch.Generator().manual_seed(int(seed))
    rows = torch.randint(0, n, (n_trees, s), generator=g)
    fmask = torch.rand((n_trees, f), generator=g) < feature_frac
    forced = torch.randint(0, f, (n_trees,), generator=g)
    fmask[torch.arange(n_trees), forced] = True
    return rows, fmask


def _route(x, feat, thr, depth: int):
    """x (N, F) shared by all trees, or (T, N, F) per tree; feat/thr
    (T, M) -> leaf index (T, N) per tree."""
    T = feat.shape[0]
    if x.dim() == 2:
        x = x[None].expand(T, -1, -1)
    N = x.shape[1]
    trees = torch.arange(T, device=x.device)[:, None]
    cols = torch.arange(N, device=x.device)[None, :]
    idx = torch.zeros((T, N), dtype=torch.long, device=x.device)
    for _ in range(depth):
        f = torch.gather(feat, 1, idx).long()
        t = torch.gather(thr, 1, idx)
        idx = idx * 2 + 1 + (x[trees, cols, f] > t).long()
    return idx - (2 ** depth - 1)


def _fit_trees(xs, ys, bs, fmask, grid, fc: ForestConfig):
    """All trees at once.  xs (T, S, F) bootstrap rows, ys (T, S) labels,
    bs (T, S, F) quantile-bin indices, fmask (T, F), grid (F, Q).
    Returns feat (T, M), thr (T, M), dist (T, 2^D, C), M = 2^D - 1."""
    T, S, F = xs.shape
    D, Q, C = fc.depth, fc.n_quantiles, fc.n_classes
    M = 2 ** D - 1
    dev = xs.device
    local = torch.zeros((T, S), dtype=torch.long, device=dev)
    feat = torch.zeros((T, M), dtype=torch.int32, device=dev)
    thr = torch.zeros((T, M), dtype=torch.float32, device=dev)
    stride_f = (Q + 1) * C                 # flat (bin, class) block per feature
    tree = torch.arange(T, device=dev)
    rows = torch.arange(S, device=dev)

    for d in range(D):
        n_nodes = 2 ** d
        base = n_nodes - 1
        size = n_nodes * F * stride_f
        # histogram: (node, F, Q+1, C) class counts, one scatter of 1.0 at
        # the combined index
        seg = (local[:, :, None] * (F * stride_f)
               + torch.arange(F, device=dev)[None, None, :] * stride_f
               + bs * C + ys[:, :, None])
        # a label >= C (the analyser caps C at max_classes) lands where the
        # reference's flat index puts it; past the end it is dropped, as
        # JAX drops out-of-bounds scatter updates
        keep = seg < size
        hist = torch.zeros(T * size, dtype=torch.float32, device=dev)
        hist.index_add_(
            0, (torch.where(keep, seg, 0) + tree[:, None, None] * size)
            .reshape(-1), keep.reshape(-1).to(torch.float32))
        hist = hist.reshape(T, n_nodes, F, Q + 1, C)

        left = torch.cumsum(hist, dim=3)[:, :, :, :Q, :]     # exact counts
        right = hist.sum(dim=3, keepdim=True) - left
        nl = left.sum(-1)                                     # (T, n, F, Q)
        nr = right.sum(-1)
        gl = 1.0 - _sum_sq(left / torch.clamp_min(nl[..., None], 1e-9))
        gr = 1.0 - _sum_sq(right / torch.clamp_min(nr[..., None], 1e-9))
        ntot = torch.clamp_min(nl + nr, 1e-9)
        imp = _fma(nl, gl, nr * gr) / ntot
        bad = (nl < fc.min_leaf) | (nr < fc.min_leaf) | \
            ~fmask[:, None, :, None]
        imp = torch.where(bad, torch.inf, imp)

        flat = imp.reshape(T, n_nodes, F * Q)
        best = torch.argmin(flat, dim=2)                       # (T, n)
        bf = best // Q
        bthr = grid[bf, best % Q]
        no_split = ~torch.isfinite(flat.amin(dim=2))
        bthr = torch.where(no_split, torch.inf, bthr)   # send everything left
        feat[:, base:base + n_nodes] = bf.to(torch.int32)
        thr[:, base:base + n_nodes] = bthr

        node_f = torch.gather(bf, 1, local)                    # (T, S)
        node_t = torch.gather(bthr, 1, local)
        go_right = xs[tree[:, None], rows[None, :], node_f] > node_t
        local = local * 2 + go_right.long()

    # recompute leaf assignment cleanly by routing from the root
    leaf = _route(xs, feat, thr, D)
    dist = torch.zeros((T, 2 ** D, C), dtype=torch.float32, device=dev)
    in_range = ys < C                       # out-of-range labels drop
    dist.index_put_((tree[:, None].expand(T, S), leaf, ys.clamp_max(C - 1)),
                    in_range.to(torch.float32), accumulate=True)
    dist = dist / torch.clamp_min(dist.sum(-1, keepdim=True), 1e-9)
    return feat, thr, dist


def _fit_forest_impl(rows, fmask, x, y, grid, fc: ForestConfig):
    """rows (T, S) bootstrap indices, fmask (T, F), x (N, F), y (N,)."""
    # quantile-bin indices are tree-independent: bins[n, f] =
    # #{q : grid[f, q] < x[n, f]}
    bins = torch.searchsorted(grid, x.T.contiguous(), right=False).T
    feat, thr, dist = _fit_trees(x[rows], y[rows], bins[rows], fmask, grid,
                                 fc)
    return {"feat": feat, "thr": thr, "dist": dist}


def forest_proba(params, x, depth: int):
    """Batched inference: (N, F) -> (N, C) mean leaf distribution over the
    trees (summed tree by tree, then scaled by float32(1/T), as the
    reference's compiled mean does)."""
    leaf = _route(x, params["feat"], params["thr"], depth)      # (T, N)
    T = leaf.shape[0]
    probs = params["dist"][torch.arange(T, device=x.device)[:, None], leaf]
    return _seq_sum(probs, 0) * float(_F32(1) / _F32(T))


class RandomForest:
    def __init__(self, fc: ForestConfig, *, device=None):
        self.fc = fc
        self.device = resolve_device(device)
        self.params = None
        self.grid = None

    def fit(self, x, y, seed: int = 0):
        fc = self.fc
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        self.grid = _quantile_grid(x, fc.n_quantiles)
        n = x.shape[0]
        s = min(fc.max_samples, n) if fc.max_samples else n
        rows, fmask = _forest_draws(seed, fc.n_trees, n, s, x.shape[1],
                                    fc.feature_frac)
        self.params = _fit_forest_impl(rows.to(self.device),
                                       fmask.to(self.device), x, y,
                                       self.grid, fc)
        return self

    def _predict_dist(self, x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return forest_proba(self.params, x, self.fc.depth)

    def predict_proba(self, x):
        return self._predict_dist(x).cpu().numpy()

    def predict(self, x):
        return torch.argmax(self._predict_dist(x), dim=-1).cpu().numpy()

    def predict_device(self, x):
        """Batched labels as a device tensor (no host sync)."""
        return torch.argmax(self._predict_dist(x), dim=-1)

    def score(self, x, y):
        return float(np.mean(self.predict(x) == np.asarray(y)))
