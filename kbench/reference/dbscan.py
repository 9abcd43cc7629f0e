"""Plain DBSCAN (Ester et al., KDD 1996) in NumPy, float64.

A point is core when at least ``min_pts`` points (itself included) lie
within ε of it (squared distance ≤ ε² with ε² rounded to float32, as the
program compares).  Clusters are the connected components of core
points under the ε relation, each named by its smallest index; a border
point (not core, a core point within ε) joins the cluster of its
smallest-named core neighbour; the rest are noise (-1).  Clusters are
then numbered 0..k-1 in the order of their names.  This fixes the one
choice DBSCAN leaves open, the cluster of a border point between two,
as the program's documented semantics do.

Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np


def labels(x: np.ndarray, eps: float, min_pts: int) -> np.ndarray:
    x = np.asarray(x, np.float64)
    n = len(x)
    if n == 0:
        return np.zeros(0, np.int64)
    eps_sq = float(np.float32(float(eps) * float(eps)))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    adj = d2 <= eps_sq
    core = adj.sum(1) >= min_pts
    name = np.full(n, -1, np.int64)
    for s in range(n):                       # components by search
        if not core[s] or name[s] >= 0:
            continue
        stack, name[s] = [s], s
        while stack:
            i = stack.pop()
            for j in np.nonzero(adj[i] & core)[0]:
                if name[j] < 0:
                    name[j] = s
                    stack.append(j)
    for i in np.nonzero(~core)[0]:
        nbr = np.nonzero(adj[i] & core)[0]
        if nbr.size:
            name[i] = name[nbr].min()
    out = np.full(n, -1, np.int64)
    for k, r in enumerate(np.unique(name[name >= 0])):
        out[name == r] = k
    return out


def near_threshold(x: np.ndarray, eps: float, rel: float = 1e-5) -> int:
    """Pairs whose squared distance lies within ``rel`` of ε², where a
    float32 computation may decide otherwise than this one."""
    x = np.asarray(x, np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    eps_sq = float(np.float32(float(eps) * float(eps)))
    iu = np.triu_indices(len(x), 1)
    return int((np.abs(d2[iu] - eps_sq) <= rel * eps_sq).sum())
