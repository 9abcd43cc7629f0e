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


def model_params_from_jax(params, device=None, dtype=None):
    """A reference parameter pytree (``repro.models.model.init``; a nested
    dict of arrays) as the port's nested dict of tensors, same keys and
    shapes.  Each leaf keeps its dtype (bf16 passes exactly through
    float32) unless ``dtype`` is given."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: model_params_from_jax(v, dev, dtype)
                for k, v in params.items()}
    a = np.asarray(params)
    name = str(a.dtype)
    t = torch.tensor(a.astype(np.float32) if name == "bfloat16" else a)
    return t.to(device=dev, dtype=dtype or getattr(torch, name))


def train_state_from_jax(state, device=None) -> dict:
    """A reference train state (``repro.train.step.init_train_state`` or a
    step's result, as numpy leaves) as the port's: params, the moments m
    and v (fp32 or bf16 tensors, or an int8 moment's (codes, scales)
    pair as a tuple of tensors), ``count`` as an int, and ``ef`` when the
    state has one."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(conv(v) for v in t)
        return model_params_from_jax(t, dev)
    out = {"params": conv(state["params"]),
           "opt": {"m": conv(state["opt"]["m"]), "v": conv(state["opt"]["v"]),
                   "count": int(np.asarray(state["opt"]["count"]))}}
    if "ef" in state:
        out["ef"] = conv(state["ef"])
    return out


def workload_db_from_reference(path, device=None, **kw) -> WorkloadDB:
    """A ``workloads.json`` written by ``repro.core.knowledge.WorkloadDB``
    (format v1–v3), loaded into the port's WorkloadDB."""
    db = WorkloadDB(device=device, **kw)
    if not db.load(path):
        raise FileNotFoundError(path)
    return db


def cost_model_from_jax(model, device=None):
    """A fitted ``repro.core.costmodel.CostModel`` as the port's, through the
    reference's own ``export_state`` (parameters as float32 lists, so the
    carried weights are exact)."""
    from repro_torch.core.costmodel import CostModel
    return CostModel.from_state(model.export_state(), device=device)
