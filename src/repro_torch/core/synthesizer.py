"""ZSL WorkloadSynthesizer: anticipate unseen multi-user hybrid workloads.

Port of ``repro/core/synthesizer.py`` (numpy; copied, same
``np.random.default_rng`` calls, so outputs are bit-identical).

From the WorkloadDB's *pure* class characterizations, synthesize instances of
every k-way hybrid class (the paper's Class Descriptor construction,
training-pipeline step 7): a hybrid observation window over classes
(i_1..i_k) is modelled as a convex mixture Σ w_j·F_{i_j} of the pure feature
distributions (k jobs sharing the cluster during the window), with mixture
weights w ~ Dirichlet(2,...,2) and blended noise.  Synthetic instances merge
into the WorkloadClassifier training set so hybrids are classifiable
*before ever being observed* (zero-shot).

Invariants (see docs/api.md "Knowledge"):

* **Pairwise stability.**  For ``k=2`` the output (instances, labels,
  prototypes) is bit-identical to the seed pairwise implementation for the
  same ``seed`` — the k=2 path consumes the rng stream in the original
  per-pair order, and Dirichlet(2,2) marginals reduce to the seed's
  Beta(2,2) draw.  Higher orders draw from independently derived rng
  streams, so enabling ``k=3`` never perturbs the pairwise instances.
* **Vectorized sampling.**  Each mixture order ≥3 is sampled in one batched
  draw across all of its combinations (no per-combination Python loop).
* **Label discipline.**  Hybrid labels continue the WorkloadDB integer
  counter (``next_label``) and are assigned in combination order: all pairs
  first (lexicographic), then all triples, etc.  The *analyser* reuses one
  synthetic WorkloadDB record per combination across analysis runs
  (``WorkloadDB.find_synthetic``), so repeated re-synthesis does not grow
  the knowledge base.
* **Eligibility.**  Synthetic records never win ``find_match`` (observing a
  real hybrid is a new-class discovery) but are eligible warm-start donors
  for ``nearest_config``.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

import numpy as np


@dataclass
class HybridClass:
    label: int
    pair: tuple       # the k-way combo of pure labels (len 2..k)
    prototype: dict   # synthetic characterization (mean/std)


def mixture_weights(rng: np.random.Generator, k: int, shape) -> np.ndarray:
    """Dirichlet(2,...,2) mixture weights of order ``k``; the trailing axis
    sums to exactly 1 (each row is a convex combination)."""
    return rng.dirichlet(np.full(k, 2.0), size=shape).astype(np.float64)


def _prototype(means: np.ndarray, stds: np.ndarray, n: int) -> dict:
    """Equal-weight class descriptor of a k-way combo: the k=2 case
    reproduces the seed's 0.5/0.5 prototype exactly."""
    k = means.shape[0]
    return {"mean": means.mean(0).astype(np.float32),
            "std": (np.sqrt((stds ** 2).sum(0)) / k).astype(np.float32),
            "n": n}


def synthesize(pure: dict, *, n_per_class: int = 200, seed: int = 0,
               next_label: int | None = None, k: int = 2):
    """pure: {label: characterization dict with 'mean','std'}.

    Returns (X_syn, y_syn, [HybridClass...]) covering every mixture order
    from 2 up to ``k`` — the class-descriptor entries reuse the
    label-generation scheme of the pure classes (unique ints).
    """
    if k < 2:
        raise ValueError(f"k-way synthesis needs k >= 2, got {k}")
    rng = np.random.default_rng(seed)
    labels = sorted(pure)
    nl = (max(labels) + 1) if next_label is None else next_label
    X, y, classes = [], [], []

    # -- pairwise (seed-identical rng consumption order) ---------------------
    for a in range(len(labels)):
        for b in range(a + 1, len(labels)):
            la, lb = labels[a], labels[b]
            ma, sa = np.asarray(pure[la]["mean"]), np.asarray(pure[la]["std"])
            mb, sb = np.asarray(pure[lb]["mean"]), np.asarray(pure[lb]["std"])
            alpha = rng.beta(2.0, 2.0, (n_per_class, 1))
            mean = alpha * ma + (1 - alpha) * mb
            std = np.sqrt(alpha ** 2 * sa ** 2 + (1 - alpha) ** 2 * sb ** 2)
            X.append(mean + rng.normal(size=mean.shape) * std)
            y.append(np.full(n_per_class, nl))
            classes.append(HybridClass(nl, (la, lb), _prototype(
                np.stack([ma, mb]), np.stack([sa, sb]), n_per_class)))
            nl += 1

    # -- higher orders: one batched Dirichlet draw per order -----------------
    M = np.stack([np.asarray(pure[l]["mean"], np.float64) for l in labels]) \
        if labels else np.zeros((0, 0))
    S = np.stack([np.asarray(pure[l]["std"], np.float64) for l in labels]) \
        if labels else np.zeros((0, 0))
    for order in range(3, k + 1):
        combos = list(combinations(range(len(labels)), order))
        if not combos:
            break
        # an rng stream derived from (seed, order): deterministic, and
        # independent of the pairwise stream above, preserving its output
        orng = np.random.default_rng([seed, order])
        idx = np.asarray(combos)                          # (C, order)
        Mc, Sc = M[idx], S[idx]                           # (C, order, F)
        w = mixture_weights(orng, order, (len(combos), n_per_class))
        mean = np.einsum("cnk,ckf->cnf", w, Mc)
        std = np.sqrt(np.einsum("cnk,ckf->cnf", w ** 2, Sc ** 2))
        X.append((mean + orng.normal(size=mean.shape) * std)
                 .reshape(-1, M.shape[1]))
        for c, combo in enumerate(combos):
            y.append(np.full(n_per_class, nl))
            classes.append(HybridClass(
                nl, tuple(labels[i] for i in combo),
                _prototype(Mc[c], Sc[c], n_per_class)))
            nl += 1

    if not X:
        return (np.zeros((0, 0), np.float32), np.zeros((0,), np.int64), [])
    return (np.concatenate(X).astype(np.float32),
            np.concatenate(y), classes)


def sample_pure(pure: dict, n_per_class: int = 200, seed: int = 0):
    """Draw training instances from the pure characterizations themselves
    (used when raw windows are unavailable, and to balance classes)."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for label, c in sorted(pure.items()):
        m, s = np.asarray(c["mean"]), np.asarray(c["std"])
        X.append(m + rng.normal(size=(n_per_class, m.shape[0])) * s)
        y.append(np.full(n_per_class, label))
    return np.concatenate(X).astype(np.float32), np.concatenate(y)
