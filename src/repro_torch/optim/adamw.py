"""AdamW for the workload predictor: the fp32 update of
``repro/optim/adamw.py`` as functions over dicts of tensors.

The operation order, the warmup/cosine schedule and the decay rule
(matrices only) are the reference's; ``torch.optim.AdamW`` rounds
differently and is not used.  Like the reference update, ``adamw_update``
does not clip (``OptConfig.grad_clip`` is carried, unused, as there).  The
quantized (int8/bf16) moments of the reference serve the managed model
stack and are not ported here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10000
    moments_dtype: str = "float32"   # only float32 is ported


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params, oc: OptConfig):
    if oc.moments_dtype != "float32":
        raise NotImplementedError(
            "only float32 moments are ported (the quantized moments serve "
            "the managed model stack, a later slice)")
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": 0}


def schedule(oc: OptConfig, count: int) -> torch.Tensor:
    """Learning rate at step ``count`` (float32, as in the reference)."""
    c = torch.tensor(float(count), dtype=torch.float32)
    warm = torch.clamp_max(c / max(oc.warmup, 1), 1.0)
    prog = torch.clamp((c - oc.warmup) / max(oc.total_steps - oc.warmup, 1),
                       0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def adamw_update(grads, opt, params, oc: OptConfig):
    """One step: returns (new_params, new_opt, lr)."""
    count = opt["count"] + 1
    dev = tree_leaves(params)[0].device
    lr = schedule(oc, count).to(dev)
    cnt = torch.tensor(float(count), dtype=torch.float32)
    b1c = (1 - torch.tensor(oc.b1, dtype=torch.float32) ** cnt).to(dev)
    b2c = (1 - torch.tensor(oc.b2, dtype=torch.float32) ** cnt).to(dev)

    def upd(g, m, v, p):
        g = g.float()
        mf = oc.b1 * m + (1 - oc.b1) * g
        vf = oc.b2 * v + (1 - oc.b2) * g * g
        step = (mf / b1c) / (torch.sqrt(vf / b2c) + oc.eps)
        if p.dim() >= 2:                                 # decay matrices only
            step = step + oc.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), mf, vf

    out = tree_map(lambda g, m, v, p: upd(g, m, v, p), grads, opt["m"],
                   opt["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, lr
