"""Mixture-of-Experts FFN: shared experts + routed top-k with capacity
dispatch.

Port of ``repro/models/moe.py``, its single-device path: tokens are
written into an (E, C, d) buffer at their cumsum positions, the experts
run as batched products (``torch.bmm``, where the reference leaves its
einsums to XLA), and the outputs are gathered back.  Nothing reads a
value back to the host, so a layer launches without a sync on the card.
The reference's expert-parallel ``shard_map`` branch (``moe.py:115-132``)
runs only under an active mesh with ``model > 1``; the port has no mesh
yet (ROADMAP queue A, item 7), so it is not here.

Capacity semantics are the reference's: C = max(int(cf·T·k/E), 1), in
that operation order and in Python floats; overflow tokens are dropped
(the residual stream carries them unchanged).  At a serving decode batch
(T = 8, k = 6, E = 64, cf = 1.25) C is 1 and most routed outputs of a
step are dropped, in the reference as here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


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
                      cf: float):
    """Capacity-dispatch xt's tokens to the experts and compute.

    xt: (T, D); gate/idx: (T, K); wi/wg: (E, D, Fe); wo: (E, Fe, D).
    Returns (T, D) (zero rows for overflowed tokens).  The reference's
    ``e_offset`` names the first expert of a shard in its ``shard_map``
    branch, which is not ported; here every expert is local.

    Kept (expert, slot) pairs are unique, so the buffer is written by
    index (``index_copy_``): dropped entries go to one extra row that is
    cut off, and no sum depends on the order of writes on the card."""
    T, D = xt.shape
    K = idx.shape[1]
    E = wi.shape[0]
    C = max(int(cf * T * K / num_experts), 1)

    flat_e = idx.reshape(-1)                                  # (T*K,)
    flat_w = gate.reshape(-1).to(xt.dtype)
    # the reference's (cumsum(oh) * oh).sum(-1) - 1, read at each entry's
    # own expert: its slot among the entries routed there before it
    pos = torch.cumsum(_one_hot_t(flat_e, E), dim=1,
                       dtype=torch.int32).gather(
        0, flat_e[None, :])[0].long() - 1
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)        # E*C: dropped

    tok = xt[:, None].expand(T, K, D).reshape(T * K, D)      # jnp.repeat
    buf = xt.new_zeros((E * C + 1, D)).index_copy_(0, slot, tok)
    buf = buf[:E * C].view(E, C, D)

    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
    out = torch.bmm(h, wo).view(E * C, D)                    # (E, C, D)

    # dropped entries read (0, 0) and weigh it by 0, as the reference does
    y = out[torch.where(keep, slot, 0)] \
        * (flat_w * keep.to(flat_w.dtype))[:, None]
    return y.view(T, K, D).sum(dim=1)


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
