"""Hand-rolled AdamW with optional quantized (int8, per-row-scaled) moments.

Port of ``repro/optim/adamw.py`` as functions over dicts of tensors.  The
operation order, the warmup/cosine schedule and the decay rule (matrices
only) are the reference's; ``torch.optim.AdamW`` rounds differently and is
not used.  Like the reference update, ``adamw_update`` does not clip: the
train step clips first (``clip_by_global_norm``).

Moments are float32 (the workload predictor's and the default), bfloat16,
or int8: a (codes, scales) pair, int8 codes with one fp32 scale per row
of the last axis.  Stacked (leading layer axis) leaves update one layer
slice at a time, so the fp32 temporaries are bounded by one slice, as the
reference's ``lax.map`` bounds them.  Nothing is updated in place: every
call returns new tensors and leaves its inputs as they were.
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
    moments_dtype: str = "float32"   # float32 | bfloat16 | int8


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of tensors (a tuple,
    such as an int8 moment's (codes, scales), is one leaf)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def _quant(x):
    """int8 codes and fp32 scales over the last axis: s = max|x| / 127
    (at least 1e-20), codes round(x / s), half to even as ``jnp.round``."""
    s = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    s = torch.clamp_min(s, 1e-20)
    return torch.round(x / s).to(torch.int8), s.to(torch.float32)


def _dequant(q, s):
    return q.to(torch.float32) * s


def _zero_moment(p, dtype: str):
    if dtype == "int8":
        return (torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                torch.zeros((*p.shape[:-1], 1), dtype=torch.float32,
                            device=p.device))
    return torch.zeros(p.shape, dtype=getattr(torch, dtype), device=p.device)


def adamw_init(params, oc: OptConfig):
    mk = lambda p: _zero_moment(p, oc.moments_dtype)
    return {"m": tree_map(mk, params), "v": tree_map(mk, params),
            "count": 0}


def schedule(oc: OptConfig, count: int) -> torch.Tensor:
    """Learning rate at step ``count`` (float32, as in the reference)."""
    c = torch.tensor(float(count), dtype=torch.float32)
    warm = torch.clamp_max(c / max(oc.warmup, 1), 1.0)
    prog = torch.clamp((c - oc.warmup) / max(oc.total_steps - oc.warmup, 1),
                       0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their fp32 sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm) in their own dtypes,
    norm)."""
    gn = global_norm(grads)
    # a 0-dim numerator: ``float / tensor`` would multiply by a reciprocal
    num = torch.full((), float(max_norm), dtype=torch.float32,
                     device=gn.device)
    scale = torch.clamp_max(num / torch.clamp_min(gn, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _slice(m, i):
    return tuple(t[i] for t in m) if isinstance(m, tuple) else m[i]


def _empty_like(m):
    if isinstance(m, tuple):
        return tuple(torch.empty_like(t) for t in m)
    return torch.empty_like(m)


def _write(dst, i, src) -> None:
    for d, s in (zip(dst, src) if isinstance(dst, tuple) else [(dst, src)]):
        d[i].copy_(s)


def adamw_update(grads, opt, params, oc: OptConfig):
    """One step: returns (new_params, new_opt, lr)."""
    count = opt["count"] + 1
    dev = tree_leaves(params)[0].device
    lr = schedule(oc, count).to(dev)
    cnt = torch.tensor(float(count), dtype=torch.float32)
    b1c = (1 - torch.tensor(oc.b1, dtype=torch.float32) ** cnt).to(dev)
    b2c = (1 - torch.tensor(oc.b2, dtype=torch.float32) ** cnt).to(dev)
    q = oc.moments_dtype == "int8"

    def upd(g, m, v, p):
        g = g.float()
        mf = _dequant(*m) if q else m.float()
        vf = _dequant(*v) if q else v.float()
        mf = oc.b1 * mf + (1 - oc.b1) * g
        vf = oc.b2 * vf + (1 - oc.b2) * g * g
        step = (mf / b1c) / (torch.sqrt(vf / b2c) + oc.eps)
        if p.dim() >= 2:                                 # decay matrices only
            step = step + oc.weight_decay * p.float()
        new_p = (p.float() - lr * step).to(p.dtype)
        nm = _quant(mf) if q else mf.to(m.dtype)
        nv = _quant(vf) if q else vf.to(v.dtype)
        return new_p, nm, nv

    def upd_leaf(g, m, v, p):
        # stacked leaves: one layer slice at a time, written into new
        # tensors, so the fp32 temporaries are one slice's
        if p.dim() >= 3 and p.shape[0] > 1:
            out = (torch.empty_like(p), _empty_like(m), _empty_like(v))
            for i in range(p.shape[0]):
                for dst, src in zip(out, upd(g[i], _slice(m, i),
                                             _slice(v, i), p[i])):
                    _write(dst, i, src)
            return out
        return upd(g, m, v, p)

    out = tree_map(upd_leaf, grads, opt["m"], opt["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, lr
