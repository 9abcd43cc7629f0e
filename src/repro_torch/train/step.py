"""Step builders: the train step (grad-accumulation microbatching,
error-feedback gradient compression, clipping, AdamW) and serve steps.

Port of ``repro/train/step.py``.  PyTorch runs eagerly, so a "built" step
is a plain closure over (cfg, opt config, tunables):

``train_step(state, batch) -> (new_state, metrics)``,
``prefill_step(params, batch, cache=None) -> (logits, cache)`` and
``serve_step(params, cache, batch) -> (logits, cache)``.

Gradients come from autograd over detached copies of the parameters that
require grad; the attention and SSD kernels differentiate through their
``torch.autograd.Function``s (``kernels/flash_attention.py``,
``kernels/ssd_scan.py``).  The train step never modifies the state it is
given: the new state is made of new tensors, so the Trainer's measured
trials can run it on the live state and drop the result, as the
reference's do (``runtime/loop.py:95-114``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, Tunables
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, tree_leaves,
                                     tree_map)
from repro_torch.optim.compression import compress_tree, ef_init


def init_train_state(gen: torch.Generator, cfg: ModelConfig, oc: OptConfig,
                     tun: Tunables):
    """Parameters drawn from ``gen`` on ``gen.device``, zero moments (and
    a zero error-feedback buffer when ``tun.grad_compression``)."""
    params = M.init(gen, cfg)
    state = {"params": params, "opt": adamw_init(params, oc)}
    if tun.grad_compression:
        state["ef"] = ef_init(params)
    return state


def loss_and_grads(params, cfg: ModelConfig, batch: dict, tun: Tunables):
    """(loss, {"ce", "aux"}, grads): the loss of ``batch`` and its
    gradient for every parameter (zeros where a parameter is unused),
    all detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, metrics = M.loss_fn(tree_map(lambda _: next(it), params), cfg,
                              batch, tun)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _microbatch(batch: dict, mb: int, i: int) -> dict:
    """Rows [i·B/mb, (i+1)·B/mb) of every batch tensor (the reference's
    reshape to (mb, B/mb, ...) and scan over the leading axis)."""
    return {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
            if v.dim() > 0 else v for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, oc: OptConfig, tun: Tunables,
                    device=None):
    """The train step on ``device`` (None: CUDA, raising without a
    card); the state must lie there, and the batch is moved there."""
    dev = resolve_device(device)

    def train_step(state, batch):
        params = state["params"]
        p0 = tree_leaves(params)[0]
        if p0.device.type != dev.type:
            raise ValueError(f"the train step runs on {dev}, the state "
                             f"lies on {p0.device}")
        batch = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                 for k, v in batch.items()}
        mb = tun.microbatches
        if mb > 1:
            acc_dt = getattr(torch, tun.accum_dtype)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            mts = []
            for i in range(mb):
                loss, mt, g = loss_and_grads(params, cfg,
                                             _microbatch(batch, mb, i), tun)
                # the accumulator is this step's own buffer
                tree_map(lambda acc, gg: acc.add_(gg.to(acc_dt)), grads, g)
                lsum = lsum + loss
                mts.append(mt)
            grads = tree_map(lambda g: g / mb, grads)
            loss = lsum / mb
            metrics = {k: torch.stack([m[k] for m in mts]).mean()
                       for k in mts[0]}
        else:
            loss, metrics, grads = loss_and_grads(params, cfg, batch, tun)

        new_state = {}
        if "ef" in state:
            grads, new_state["ef"] = compress_tree(grads, state["ef"])
        grads, gnorm = clip_by_global_norm(grads, oc.grad_clip)
        new_params, new_opt, lr = adamw_update(grads, state["opt"], params,
                                               oc)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step


def make_prefill_step(cfg: ModelConfig, tun: Tunables):
    def prefill_step(params, batch, cache=None):
        return M.prefill(params, cfg, batch, tun, cache=cache)
    return prefill_step


def make_serve_step(cfg: ModelConfig, tun: Tunables):
    def serve_step(params, cache, batch):
        return M.decode(params, cfg, batch, cache, tun)
    return serve_step
