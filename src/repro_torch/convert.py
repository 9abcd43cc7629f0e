"""Carry trained state from the JAX reference into the port.

Takes what ``repro`` objects hold, as numpy arrays (``np.asarray`` of each
leaf), and returns the port's dicts of tensors — so a reference and a port
can hold the same trained state and be compared decision for decision.
Imports nothing of ``repro``: the caller hands over plain arrays.
``device=None`` means CUDA, as for every entry point of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.knowledge import WorkloadDB
from repro_torch.kernels.dispatch import resolve_device


def forest_params_from_jax(params, device=None) -> dict:
    """``repro.core.forest.RandomForest.params`` — the (feat, thr, dist)
    tuple of stacked tree arrays — as the port's parameter dict."""
    feat, thr, dist = (np.asarray(a) for a in params)
    dev = resolve_device(device)
    return {"feat": torch.as_tensor(feat.astype(np.int32), device=dev),
            "thr": torch.as_tensor(thr.astype(np.float32), device=dev),
            "dist": torch.as_tensor(dist.astype(np.float32), device=dev)}


def predictor_params_from_jax(params, device=None) -> dict:
    """``repro.core.lstm.WorkloadPredictor.params`` (a nested dict of
    arrays) as the port's nested dict of float32 tensors."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: predictor_params_from_jax(v, dev)
                for k, v in params.items()}
    return torch.tensor(np.asarray(params, np.float32), device=dev)


def workload_db_from_reference(path, device=None, **kw) -> WorkloadDB:
    """A ``workloads.json`` written by ``repro.core.knowledge.WorkloadDB``
    (format v1–v3), loaded into the port's WorkloadDB."""
    db = WorkloadDB(device=device, **kw)
    if not db.load(path):
        raise FileNotFoundError(path)
    return db
