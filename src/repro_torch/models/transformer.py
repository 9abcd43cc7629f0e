"""Decoder-only transformer LM covering the dense / moe / vlm families.

Port of ``repro/models/transformer.py``.  Layers keep the reference's
stacked layout (leading L axis); the reference's ``lax.scan`` over them is
a Python loop, and gemma2's per-layer window rides along as a 0-dim
tensor, as the traced scan scalar does in the reference.  Each layer body
runs under the ``remat`` tunable's policy (``REMAT_POLICY``) while grad is
enabled and something in it needs grad — training; the serving path runs
the body as it is.

MoE layers (``models/moe.py``) replace the MLP of every layer, but for
deepseek's dense layer 0 (``params["layer0"]``, unstacked, its cache in
``k0``/``v0``); their auxiliary losses are summed over the layers.  The
vlm family prepends ``num_patches`` projected patch embeddings to the
text, attending to each other bidirectionally (``prefix_len``) on the
xla route; the pallas route drops the prefix, as the reference's does
(ROADMAP C10).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.runtime import trace as T


# 2-D matrix products: the counterpart of ``dots_with_no_batch_dims_saveable``
# (``x @ W`` of a (B, S, d) activation reaches ``aten.mm``; attention's
# batched einsums reach ``aten.bmm`` and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, **kw):
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


# the reference's policies (``transformer.py:18-22``): "none" saves every
# activation, "dots" only the 2-D matmul outputs, "full" only the body's
# inputs
REMAT_POLICY = {
    "none": lambda fn: fn,
    "dots": lambda fn: _checkpointed(fn, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)),
    "full": _checkpointed,
}


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat(fn, tun, *inputs):
    """``fn`` under ``tun.remat``'s policy when grad is enabled and one of
    ``inputs`` (tensors or dicts of them) needs grad, else ``fn``."""
    if torch.is_grad_enabled() and any(_needs_grad(t) for t in inputs):
        return REMAT_POLICY[tun.remat](fn)
    return fn


def _is_moe_layer(cfg, idx: int) -> bool:
    if cfg.moe is None:
        return False
    if cfg.moe.first_layer_dense and idx == 0:
        return False
    return True


def _dense_ff0(cfg) -> int:
    """FLOP-matched dense FFN width for deepseek's dense first layer."""
    m = cfg.moe
    return (m.top_k + m.num_shared) * m.d_expert


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_init(gen, cfg, dtype, lead, moe_layer: bool,
               d_ff: int | None = None):
    """Layers stacked along ``lead`` (``()``: one unstacked layer)."""
    p = {
        "ln1": torch.zeros((*lead, cfg.d_model), dtype=dtype,
                           device=gen.device),
        "attn": L.attn_init(gen, cfg, dtype, lead=lead),
        "ln2": torch.zeros((*lead, cfg.d_model), dtype=dtype,
                           device=gen.device),
    }
    if moe_layer:
        p["moe"] = MOE.moe_init(gen, cfg, dtype, lead=lead)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, d_ff or cfg.d_ff, dtype,
                              lead=lead)
    return p


def _n_scan(cfg) -> int:
    """Layers in the stack: all but deepseek's dense layer 0."""
    dense0 = cfg.moe is not None and not _is_moe_layer(cfg, 0)
    return cfg.n_layers - dense0


def init(gen: torch.Generator, cfg):
    """Parameters drawn from ``gen`` on ``gen.device``."""
    dtype = _dtype(cfg)
    params = {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
              "ln_f": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device)}
    n_scan = _n_scan(cfg)
    if n_scan < cfg.n_layers:
        params["layer0"] = layer_init(gen, cfg, dtype, (), False,
                                      _dense_ff0(cfg))
    params["layers"] = layer_init(gen, cfg, dtype, (n_scan,),
                                  cfg.moe is not None)
    if cfg.family == "vlm":
        params["patch_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model,
                                            dtype)
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_padded,
                                      dtype)
    return params


def layer_windows(cfg, n: int, device=None):
    """Per-layer window scalars: 0 = full attention."""
    idx = torch.arange(n, device=device)
    if cfg.window_pattern == "alternating":
        return torch.where(idx % 2 == 0, cfg.window, 0).to(torch.int32)
    return torch.full((n,), cfg.window, dtype=torch.int32, device=device)


def _unstack(stacked, n: int) -> list:
    """A stacked parameter tree as ``n`` per-layer trees of views (one
    ``unbind`` per leaf, no copies)."""
    if isinstance(stacked, dict):
        per = {k: _unstack(v, n) for k, v in stacked.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(stacked.unbind(0))


def block_apply(p, x, cfg, tun, *, positions, window, prefix_len=0,
                kv=None, kv_pos=None, kv_len=None):
    """One transformer block.  With ``kv``: one decode step against the
    cache (ck, cv), written in place (``layers.attn_decode``).  Returns
    (x, (k, v), aux): aux is the MoE layer's load-balancing loss, a 0-dim
    fp32 zero for a dense layer."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kv is not None:
        h = L.attn_decode(p["attn"], h, cfg, kv, positions=positions,
                          kv_pos=kv_pos, kv_len=kv_len, window=window,
                          prefix_len=prefix_len, softcap=cfg.attn_softcap)
        new_kv = kv
    else:
        h, new_kv = L.attn_apply(p["attn"], h, cfg, positions=positions,
                                 causal=True, window=window,
                                 prefix_len=prefix_len,
                                 q_chunk=tun.attn_q_chunk, impl=tun.attn_impl)
    x = x + h
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        h, aux = MOE.moe_apply(p["moe"], h, cfg,
                               capacity_factor=tun.capacity_factor)
    else:
        h = L.mlp_apply(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, new_kv, aux


def _embed_tokens(params, cfg, tokens):
    tok = params["embed"][tokens]
    if cfg.scale_embed:
        tok = tok * torch.tensor(cfg.d_model ** 0.5, dtype=tok.dtype)
    return tok


def embed_input(params, cfg, batch):
    """tokens (+ the vlm family's patch embeddings) -> (x, positions,
    prefix_len)."""
    tok = _embed_tokens(params, cfg, batch["tokens"])
    prefix_len = 0
    x = tok
    if cfg.family == "vlm":
        patches = batch["patches"].to(tok.dtype) @ params["patch_proj"]
        x = torch.cat([patches, tok], dim=1)
        prefix_len = cfg.num_patches
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions, prefix_len


def _head(params, cfg, x):
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head = params.get("head")
    logits = x @ head if head is not None else x @ params["embed"].T
    return L.softcap(logits, cfg.final_softcap)


def forward(params, cfg, batch, tun, *, return_cache=False, cache=None):
    """Train / prefill forward.  Returns (logits, aux_loss, cache|None).

    With ``return_cache`` the layers' keys and values go into ``cache``
    ({"k", "v"}: (L, B, capacity, K, hd), capacity >= S, and deepseek's
    {"k0", "v0"}: (B, capacity, K, hd)), written in place into positions
    [0, S) and cast to its dtype; without one, a cache of exactly S
    positions in the model dtype is allocated."""
    x, positions, prefix_len = embed_input(params, cfg, batch)
    S = x.shape[1]
    if return_cache and cache is None:
        cache = init_cache(cfg, x.shape[0], S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # layer 0's window: the reference's int32(0), full attention; None
    # masks the same and copies no scalar to the card
    if "layer0" in params:
        x, (k, v), a = block_apply(params["layer0"], x, cfg, tun,
                                   positions=positions, window=None,
                                   prefix_len=prefix_len)
        aux = aux + a
        if return_cache:
            cache["k0"][:, :S] = k
            cache["v0"][:, :S] = v
    n_scan = _n_scan(cfg)
    wins = layer_windows(cfg, n_scan, device=x.device).unbind(0)
    layers = _unstack(params["layers"], n_scan)

    def body(p_l, x, win):
        return block_apply(p_l, x, cfg, tun, positions=positions,
                           window=win, prefix_len=prefix_len)
    body = remat(body, tun, x, params["layers"])
    for i in range(n_scan):
        x, (k, v), a = body(layers[i], x, wins[i])
        aux = aux + a
        if return_cache:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    logits = _head(params, cfg, x)
    return logits, aux, (cache if return_cache else None)


def decode_step(params, cfg, batch, cache, tun):
    """One-token decode. batch: {"tokens": (B,1), "pos": an int or a
    0-dim int64 tensor on the device}.  cache: {"k": (L,B,S,K,hd), "v":
    ...} (+ "k0"/"v0"), updated IN PLACE at ``pos`` and returned.
    Returns (logits, cache).  Capture-safe (``layers.decode_positions``):
    a CUDA graph can hold the step with ``pos`` on the device."""
    with T.detail("model.embed"):
        x = _embed_tokens(params, cfg, batch["tokens"])
        dev = x.device
        step = L.decode_positions(batch["pos"], cache["k"].shape[2], dev)
    n_scan = _n_scan(cfg)
    first = cfg.n_layers - n_scan
    if "layer0" in params:
        with T.detail("model.layer", index=0):
            x, _, _ = block_apply(params["layer0"], x, cfg, tun, window=None,
                                  kv=(cache["k0"], cache["v0"]), **step)
    with T.detail("model.views"):
        wins = layer_windows(cfg, n_scan, device=dev).unbind(0)
        layers = _unstack(params["layers"], n_scan)
    for i in range(n_scan):
        with T.detail("model.layer", index=first + i):
            x, _, _ = block_apply(layers[i], x, cfg, tun, window=wins[i],
                                  kv=(cache["k"][i], cache["v"][i]), **step)
    with T.detail("model.head"):
        logits = _head(params, cfg, x)
    return logits, cache


def init_cache(cfg, batch: int, seq: int, dtype=None, device=None):
    """Zeroed KV cache {"k", "v"}: (L, batch, seq, K, hd) in ``dtype``
    (default: the model dtype) on ``device`` (None: CUDA), and deepseek's
    {"k0", "v0"}: (batch, seq, K, hd) for its dense layer 0."""
    dtype = dtype or _dtype(cfg)
    dev = resolve_device(device)
    n_scan = _n_scan(cfg)
    shape = (batch, seq, cfg.n_kv_heads, cfg.hd)
    cache = {}
    if n_scan < cfg.n_layers:
        cache["k0"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v0"] = torch.zeros(shape, dtype=dtype, device=dev)
    cache["k"] = torch.zeros((n_scan, *shape), dtype=dtype, device=dev)
    cache["v"] = torch.zeros((n_scan, *shape), dtype=dtype, device=dev)
    return cache
