"""Workload characterization (Algorithm 2): per-cluster summary statistics.

Port of ``repro/core/characterize.py`` (numpy; copied).

The characterization is the full set the paper names: mean, std, min, max,
90th and 75th percentile per feature, plus the centroid and member count.
"""
from __future__ import annotations

import numpy as np


def characterize(window_means: np.ndarray) -> dict:
    """window_means: (n, F) windows belonging to one cluster."""
    w = np.asarray(window_means, np.float32)
    return {
        "mean": w.mean(0),
        "std": w.std(0, ddof=1) if w.shape[0] > 1 else np.zeros(w.shape[1], np.float32),
        "min": w.min(0),
        "max": w.max(0),
        "p75": np.percentile(w, 75, axis=0).astype(np.float32),
        "p90": np.percentile(w, 90, axis=0).astype(np.float32),
        "n": int(w.shape[0]),
    }


def l2_drift(c1: dict, c2: dict) -> float:
    """Drift metric: L2 norm between mean vectors (Algorithm 2)."""
    return float(np.linalg.norm(np.asarray(c1["mean"]) - np.asarray(c2["mean"])))


def merge_characterizations(old: dict, new: dict, *,
                            min_new_weight: float = 0.0) -> dict:
    """Update a stored characterization with a new batch (running merge).

    ``min_new_weight`` is an EMA floor on the fresh batch's blend weight
    (``KnowledgeConfig.drift_alpha``): with the default 0 the merge is purely
    count-weighted (the seed behaviour — a long history freezes the stored
    characterization), while a positive floor keeps the class tracking a
    slowly drifting workload regardless of how much history it has."""
    n1, n2 = old["n"], new["n"]
    n = n1 + n2
    w2 = n2 / n
    if min_new_weight > w2:
        w2 = min_new_weight
        w1 = 1.0 - w2
    else:
        w1 = n1 / n          # exact seed arithmetic when the floor is idle
    mean = w1 * old["mean"] + w2 * new["mean"]
    # combine variances about the new mean
    var = (w1 * (old["std"] ** 2 + (old["mean"] - mean) ** 2)
           + w2 * (new["std"] ** 2 + (new["mean"] - mean) ** 2))
    return {
        "mean": mean.astype(np.float32),
        "std": np.sqrt(var).astype(np.float32),
        "min": np.minimum(old["min"], new["min"]),
        "max": np.maximum(old["max"], new["max"]),
        "p75": (w1 * old["p75"] + w2 * new["p75"]).astype(np.float32),
        "p90": (w1 * old["p90"] + w2 * new["p90"]).astype(np.float32),
        "n": n,
    }
