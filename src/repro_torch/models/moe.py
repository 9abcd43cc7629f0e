"""Mixture-of-Experts FFN: shared experts + routed top-k with capacity
dispatch.

Port of ``repro/models/moe.py``.  Two dispatch paths:

* **single-device**: tokens are written into an (E, C, d) buffer at their
  cumsum positions, the experts run as batched products (``torch.bmm``,
  where the reference leaves its einsums to XLA), and the outputs are
  gathered back.  Nothing reads a value back to the host, so a layer
  launches without a sync on the card.
* **expert-parallel** (a mesh is set with ``model = tp > 1`` and
  ``E % tp == 0``): the reference's ``shard_map`` branch in SPMD form.
  Every rank holds the whole batch and every expert's weights.  Rank
  (i, j) dispatches the tokens of batch block i (over 'data', or
  ('pod', 'data')) to its experts j·E/tp … (j+1)·E/tp, with the capacity
  of its block; the partial outputs are summed over 'model' and the
  blocks gathered back to (T, d).  Under autograd the loss is replicated,
  so the cotangent of the gathered output is every rank's already: the
  combine's backward only cuts out the rank's block, and the slices'
  backward sums each rank's share of the input and expert-weight
  gradients over the whole mesh, so every rank ends with the whole
  gradient (a sum over 'model' in the backward would count it tp times).

Capacity semantics are the reference's: C = max(int(cf·T·k/E), 1), T the
tokens of one shard, in that operation order and in Python floats;
overflow tokens are dropped (the residual stream carries them unchanged).
At a serving decode batch (T = 8, k = 6, E = 64, cf = 1.25) C is 1 and most
routed outputs of a step are dropped, in the reference as here.  At
data > 1 each block takes its own capacity, so the expert-parallel output
differs from the single-device one where capacity binds, in both packages.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import rules


def moe_init(gen, cfg, dtype, lead=()):
    """Router, stacked expert weights (E, d, Fe)/(E, Fe, d), and the
    shared and parallel dense FFNs where ``cfg.moe`` has them; ``lead``
    prepends stacked axes (the layer axis)."""
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_expert, m.num_experts

    def experts(shape, fan_in):
        # scaled in place: deepseek's stacked wi is 20 GB in fp32
        return L._normal(gen, (*lead, *shape)).mul_(fan_in ** -0.5).to(dtype)
    p = {
        "router": L.dense_init(gen, d, e, dtype, scale=0.02, lead=lead),
        "wi": experts((e, d, fe), d),
        "wg": experts((e, d, fe), d),
        "wo": experts((e, fe, d), fe),
    }
    if m.num_shared:
        p["shared"] = L.mlp_init(gen, d, m.num_shared * fe, dtype, lead=lead)
    if m.dense_ff:
        p["dense"] = L.mlp_init(gen, d, m.dense_ff, dtype, lead=lead)
    return p


def route(probs, k: int):
    """The top-``k`` (values, indices) of each row of ``probs``, ties
    broken toward the lower index as ``jax.lax.top_k`` breaks them
    (``torch.topk`` does not): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _one_hot_t(idx, n: int):
    """The (n, len(idx)) int32 one-hot of 1-D ``idx``, transposed: a
    comparison, so no check of the indices reads them back to the host,
    and sums and scans over the entries run along the inner axis (a scan
    along the outer one took 0.43 ms a layer on an H100)."""
    return (torch.arange(n, device=idx.device)[:, None] == idx).to(
        torch.int32)


def _dispatch_compute(xt, gate, idx, wi, wg, wo, *, num_experts: int,
                      cf: float, e_offset: int = 0):
    """Capacity-dispatch xt's tokens to the local expert slice and compute.

    xt: (T, D); gate/idx: (T, K); wi/wg: (E_l, D, Fe); wo: (E_l, Fe, D).
    ``e_offset``: first global expert id owned here.  Returns the (T, D)
    partial output (zero rows for tokens routed to non-local or overflowed
    experts).

    Kept (expert, slot) pairs are unique, so the buffer is written by
    index (``index_copy_``): dropped entries go to one extra row that is
    cut off, and no sum depends on the order of writes on the card."""
    T, D = xt.shape
    K = idx.shape[1]
    E_l = wi.shape[0]
    C = max(int(cf * T * K / num_experts), 1)

    flat_e = idx.reshape(-1)                                  # (T*K,)
    flat_w = gate.reshape(-1).to(xt.dtype)
    own = None                                  # every expert is local
    if e_offset or E_l != num_experts:
        # an expert-parallel shard: entries routed elsewhere match no row
        # of the one-hot and are dropped (the single-device path spends
        # no launches on this: a decode step is launch-bound)
        flat_e = flat_e - e_offset
        own = (flat_e >= 0) & (flat_e < E_l)
    # the reference's (cumsum(oh) * oh).sum(-1) - 1, read at each entry's
    # own expert: its slot among the entries routed there before it
    at = flat_e if own is None else torch.where(own, flat_e, 0)
    pos = torch.cumsum(_one_hot_t(flat_e, E_l), dim=1,
                       dtype=torch.int32).gather(0, at[None, :])[0].long() - 1
    keep = pos < C if own is None else own & (pos < C)
    slot = torch.where(keep, flat_e * C + pos, E_l * C)      # E_l*C: dropped

    tok = xt[:, None].expand(T, K, D).reshape(T * K, D)      # jnp.repeat
    buf = xt.new_zeros((E_l * C + 1, D)).index_copy_(0, slot, tok)
    buf = buf[:E_l * C].view(E_l, C, D)

    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
    out = torch.bmm(h, wo).view(E_l * C, D)                  # (E_l, C, D)

    # dropped entries read (0, 0) and weigh it by 0, as the reference does
    y = out[torch.where(keep, slot, 0)] \
        * (flat_w * keep.to(flat_w.dtype))[:, None]
    return y.view(T, K, D).sum(dim=1)


class _Slice(torch.autograd.Function):
    """Rows [lo, hi) of a tensor every rank of ``group`` holds whole.  The
    backward puts the slice's gradient in place among zeros and sums it
    over ``group``: each rank holds a share of the whole gradient, and
    every rank gets the whole of it."""

    @staticmethod
    def forward(ctx, x, lo: int, hi: int, group):
        ctx.shape, ctx.lo, ctx.hi, ctx.group = x.shape, lo, hi, group
        return x[lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.lo:ctx.hi] = g
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


class _Combine(torch.autograd.Function):
    """The partial outputs of one token block summed over ``model``, then
    the blocks gathered over ``batch`` (None: one block) in its rank order
    to the whole (T, D).  The loss downstream is replicated, so the
    backward takes the block's rows of the cotangent as they are."""

    @staticmethod
    def forward(ctx, y, model, batch):
        y = y.clone()
        dist.all_reduce(y, group=model)
        ctx.rows, ctx.block = y.shape[0], 0
        if batch is None or dist.get_world_size(batch) == 1:
            return y
        ctx.block = dist.get_group_rank(batch, dist.get_rank())
        parts = [torch.empty_like(y) for _ in range(
            dist.get_world_size(batch))]
        dist.all_gather(parts, y, group=batch)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.block * ctx.rows
        return g[lo:lo + ctx.rows], None, None


def _expert_parallel(mesh, xt, gate, idx, p, *, num_experts: int, tp: int,
                     cf: float):
    """The reference's ``shard_map`` branch on this rank: its token block,
    its experts, the partials summed over 'model' and the blocks gathered
    over the batch axes."""
    T = xt.shape[0]
    batch = rules._resolve(("batch",), mesh)[0]       # 'data'/('pod','data')
    if batch is None:        # no batch axis: every rank takes every token
        b_group, i, dp = None, 0, 1
    else:
        b_group, i = mesh.group(batch), mesh.coordinate(batch)
        dp = dist.get_world_size(b_group)
    if T % dp:
        raise ValueError(f"{T} tokens do not split over {dp} batch shards")
    j = mesh.coordinate("model")
    El, Tl = num_experts // tp, T // dp
    everyone = mesh.group(mesh.axis_names)

    def rows(a, lo, n):
        return _Slice.apply(a, lo, lo + n, everyone)
    y = _dispatch_compute(
        rows(xt, i * Tl, Tl), rows(gate.to(xt.dtype), i * Tl, Tl),
        idx[i * Tl:(i + 1) * Tl],
        rows(p["wi"], j * El, El), rows(p["wg"], j * El, El),
        rows(p["wo"], j * El, El),
        num_experts=num_experts, cf=cf, e_offset=j * El)
    return _Combine.apply(y, mesh.group("model"), b_group)


def moe_apply(p, x, cfg, *, capacity_factor: float | None = None):
    """x: (B, S, D) -> (y, aux_loss)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    T = B * S
    xt = x.reshape(T, D)

    logits = xt @ p["router"].to(xt.dtype)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate, idx = route(probs, K)                               # (T, K)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # load-balancing aux loss (Switch-style)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(_one_hot_t(idx[:, 0], E).to(torch.float32), dim=1)
    aux = E * torch.sum(me * ce) * m.router_aux_weight

    mesh = rules.current_mesh()
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    if mesh is not None and tp > 1 and E % tp == 0:
        y = _expert_parallel(mesh, xt, gate, idx, p, num_experts=E, tp=tp,
                             cf=cf)
    else:
        y = _dispatch_compute(xt, gate, idx, p["wi"], p["wg"], p["wo"],
                              num_experts=E, cf=cf)
    if m.num_shared:
        y = y + L.mlp_apply(p["shared"], xt[None])[0]
    if m.dense_ff:
        y = y + L.mlp_apply(p["dense"], xt[None])[0]
    return y.reshape(B, S, D), aux


def expert_load(p, x, cfg):
    """Telemetry: fraction of tokens landing on the busiest expert
    (imbalance)."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1) @ p["router"].to(x.dtype)
    idx = torch.argmax(logits, dim=-1)
    counts = torch.bincount(idx, minlength=m.num_experts)
    return counts.max() / max(T / m.num_experts, 1.0)
