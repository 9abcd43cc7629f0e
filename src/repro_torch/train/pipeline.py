"""GPipe-style pipeline parallelism over a 'stage' mesh axis.

Port of ``repro/train/pipeline.py``.  Layer stacks are partitioned into S
stages and microbatched: stage s processes microbatch m = t - s at tick t,
activations hop stages point to point, and every stage computes every tick
(inactive ticks are masked — the standard SPMD-gpipe trade: S - 1 bubble
ticks of wasted compute for one hop per tick, which is what a slow link
wants).  One rank is one stage: rank s of the mesh's 'stage' group holds
the whole ``params_staged`` and applies its slice ``params_staged[s]``.

``gpipe_apply`` is family-agnostic: it takes the per-stage stacked params
and a ``stage_fn(stage_params, x)`` (e.g. a loop over that stage's
layers).  Forward only, as the reference: nothing differentiates it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map


def stage_split(params_stacked, n_stages: int):
    """Reshape stacked layer params (L, ...) -> (S, L/S, ...)."""
    def f(a):
        L = a.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return tree_map(f, params_stacked)


def _hop(y, group, ranks: list, s: int):
    """Send ``y`` to the next stage and receive the previous stage's, in
    one batch of an isend and an irecv, so that no stage blocks."""
    S = len(ranks)
    if S == 1:
        return y
    recv = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), ranks[(s + 1) % S], group),
           dist.P2POp(dist.irecv, recv, ranks[(s - 1) % S], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def gpipe_apply(params_staged, x, stage_fn, *, mesh, n_microbatches: int,
                axis: str = "stage"):
    """x: (B, ...) -> (B, ...) after all stages, pipelined; every rank
    returns the last stage's output.

    params_staged: tree with leading (S, L/S, ...) axes (see stage_split).
    stage_fn(stage_params, x_mb) applies one stage to one microbatch.
    """
    S = mesh.shape[axis]
    M = n_microbatches
    B = x.shape[0]
    assert B % M == 0, (B, M)
    xs = x.reshape(M, B // M, *x.shape[1:])
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)      # by stage
    s = mesh.coordinate(axis)
    p_local = tree_map(lambda a: a[s], params_staged)

    carry = torch.zeros_like(xs[0])                  # inbound activation
    out = torch.zeros_like(xs)                       # collected at last stage
    for t in range(M + S - 1):
        m = t - s                                    # microbatch index here
        y = stage_fn(p_local, xs[min(t, M - 1)] if s == 0 else carry)
        active = 0 <= m < M
        if not active:
            y = torch.zeros_like(y)
        elif s == S - 1:                             # last stage collects
            out[m] = y
        carry = _hop(y, group, ranks, s)
    dist.broadcast(out, src=ranks[S - 1], group=group)
    return out.reshape(B, *x.shape[1:])
