"""SSM language models: the pure Mamba2 LM and the Zamba2 hybrid.

Port of ``repro/models/ssm_lm.py``.  Layers keep the reference's stacked
layout (leading L axis; Zamba2's groups as (G, period)), so its parameters
convert leaf by leaf; its ``lax.scan``s over layers and groups are Python
loops here.

Zamba2: ``n_layers`` SSD layers; one *shared* attention+MLP block (a single
set of weights) runs at the start of every ``hybrid_period``-layer group,
specialised per invocation by LoRA deltas (rank ``lora_rank``) on ``wq``
and ``wi``; the trailing remainder layers follow the last group.

Under training (grad enabled) each SSD layer runs under the ``remat``
tunable's policy, and each Zamba2 group (shared block + its SSD layers)
under it again, at the reference's sites (``ssm_lm.py:76, 187, 200``).

Caches (``cache_mamba``/``cache_zamba``): the SSM state of every layer in
fp32, the last ``d_conv - 1`` pre-conv rows in the model dtype, and for
Zamba2 the shared block's keys and values per group, (G, B, S, K, hd), in
the cache dtype.  Prefill writes into a given cache in place; decode
updates it in place and returns it.  On the ``attn_impl="pallas"`` route
an SSD layer's decode step on the card runs the fused kernel of
``kernels/ssm_step.py``; it writes the layer's cache views itself, so
nothing is copied back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.transformer import _unstack, remat
from repro_torch.runtime import trace as T


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def ssm_layer_init(gen, cfg, dtype, lead=()):
    return {"ln": torch.zeros((*lead, cfg.d_model), dtype=dtype,
                              device=gen.device),
            "mixer": M2.mamba2_init(gen, cfg, dtype, lead=lead)}


def _ssm_block(p_l, x, cfg, tun):
    h, st = M2.mamba2_apply(p_l["mixer"],
                            L.rmsnorm(x, p_l["ln"], cfg.norm_eps), cfg,
                            chunk=tun.ssm_chunk, impl=tun.attn_impl)
    return x + h, st


def _step_into(p_l, x, cfg, st, tun):
    """One SSD layer's decode step against its cache views ``st``, which
    end up holding the new state: the kernel route updates them in place,
    the plain step's new tensors are copied into them."""
    h, new = M2.mamba2_step(p_l["mixer"],
                            L.rmsnorm(x, p_l["ln"], cfg.norm_eps), cfg, st,
                            impl=tun.attn_impl)
    x = x + h
    if new is not st:
        _write_state(st, new)
    return x


def _logits(params, cfg, x):
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.softcap(x @ params["embed"].T, cfg.final_softcap)


def _write_state(dst, st) -> None:
    """Copy a layer's {"ssm", "conv"} state into cache views, in place."""
    dst["ssm"].copy_(st["ssm"])
    dst["conv"].copy_(st["conv"])


def _layer_state(cache, *idx):
    return {"ssm": cache["ssm"][idx], "conv": cache["conv"][idx]}


# ---------------------------------------------------------------------------
# pure Mamba2 LM
# ---------------------------------------------------------------------------


def init_mamba(gen: torch.Generator, cfg):
    dtype = _dtype(cfg)
    return {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "layers": ssm_layer_init(gen, cfg, dtype, lead=(cfg.n_layers,)),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
    }


def forward_mamba(params, cfg, batch, tun, *, return_cache=False, cache=None):
    """Prefill forward.  Returns (logits, aux (0), cache|None); with
    ``return_cache`` every layer's final SSM and conv state goes into
    ``cache`` (allocated when not given)."""
    x = params["embed"][batch["tokens"]]
    if return_cache and cache is None:
        cache = cache_mamba(cfg, x.shape[0], x.shape[1], device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    block = remat(_ssm_block, tun, x, params["layers"])
    for i in range(cfg.n_layers):
        x, st = block(layers[i], x, cfg, tun)
        if return_cache:
            _write_state(_layer_state(cache, i), st)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux, (cache if return_cache else None)


def decode_mamba(params, cfg, batch, cache, tun):
    """One-token decode; ``cache`` is updated IN PLACE and returned."""
    with T.detail("model.embed"):
        x = params["embed"][batch["tokens"]]
    with T.detail("model.views"):
        layers = _unstack(params["layers"], cfg.n_layers)
    for i in range(cfg.n_layers):
        with T.detail("model.layer", index=i):
            x = _step_into(layers[i], x, cfg, _layer_state(cache, i), tun)
    with T.detail("model.head"):
        logits = _logits(params, cfg, x)
    return logits, cache


def cache_mamba(cfg, batch: int, seq: int, dtype=None, device=None):
    """Zeroed per-layer states.  ``dtype`` (the KV cache dtype) touches
    no tensor here: the SSM state stays fp32 and the conv rows stay in the
    model dtype, as the reference's cache cast touches only k/v."""
    return M2.mamba2_init_state(cfg, batch, _dtype(cfg),
                                device=resolve_device(device),
                                lead=(cfg.n_layers,))


# ---------------------------------------------------------------------------
# Zamba2 hybrid
# ---------------------------------------------------------------------------


def _zdims(cfg):
    G = cfg.n_layers // cfg.hybrid_period
    R = cfg.n_layers - G * cfg.hybrid_period
    return G, R


def init_zamba(gen: torch.Generator, cfg):
    dtype = _dtype(cfg)
    G, R = _zdims(cfg)
    per = cfg.hybrid_period
    dev = gen.device
    params = {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "groups": ssm_layer_init(gen, cfg, dtype, lead=(G, per)),
        "shared": {
            "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "attn": L.attn_init(gen, cfg, dtype),
            "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
        },
        "ln_f": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if R:
        params["rest"] = ssm_layer_init(gen, cfg, dtype, lead=(R,))
    r = cfg.lora_rank
    H = cfg.n_heads * cfg.hd

    def lora(d_out):
        return {"lora_a": (L._normal(gen, (G, cfg.d_model, r)) * 0.02
                           ).to(dtype),
                "lora_b": torch.zeros((G, r, d_out), dtype=dtype, device=dev)}
    params["lora"] = {"attn": lora(H), "mlp": lora(cfg.d_ff)}
    return params


def _shared_effective(shared, lora):
    """Shared block weights + this invocation's LoRA deltas."""
    attn = dict(shared["attn"])
    attn["wq"] = attn["wq"] + lora["attn"]["lora_a"] @ lora["attn"]["lora_b"]
    mlp = dict(shared["mlp"])
    mlp["wi"] = mlp["wi"] + lora["mlp"]["lora_a"] @ lora["mlp"]["lora_b"]
    return dict(shared, attn=attn, mlp=mlp)


def _shared_block(shared, lora, x, cfg, tun, *, positions, kv=None,
                  kv_pos=None, kv_len=None):
    """The shared attention+MLP block.  With ``kv``: one decode step
    against this group's cache (ck, cv), written in place
    (``layers.attn_decode``).  Returns (x, (k, v))."""
    p = _shared_effective(shared, lora)
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kv is not None:
        h = L.attn_decode(p["attn"], h, cfg, kv, positions=positions,
                          kv_pos=kv_pos, kv_len=kv_len)
    else:
        h, kv = L.attn_apply(p["attn"], h, cfg, positions=positions,
                             causal=True, q_chunk=tun.attn_q_chunk,
                             impl=tun.attn_impl)
    x = x + h
    x = x + L.mlp_apply(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def _zamba_layers(params, cfg):
    """(per-group LoRA trees, per-group lists of layer trees, rest)."""
    G, R = _zdims(cfg)
    per = cfg.hybrid_period
    loras = _unstack(params["lora"], G)
    groups = [_unstack(g, per) for g in _unstack(params["groups"], G)]
    rest = _unstack(params["rest"], R) if R else []
    return loras, groups, rest


def forward_zamba(params, cfg, batch, tun, *, return_cache=False, cache=None):
    """Prefill forward.  Returns (logits, aux (0), cache|None); with
    ``return_cache`` the shared block's keys and values of each group go
    into positions [0, S) of ``cache`` and every SSD layer's final state
    into its slot (a cache of exactly S positions is allocated when none
    is given)."""
    x = params["embed"][batch["tokens"]]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    if return_cache and cache is None:
        cache = cache_zamba(cfg, x.shape[0], S, device=x.device)
    loras, groups, rest = _zamba_layers(params, cfg)
    inner = remat(_ssm_block, tun, x, params)

    def outer(lora, layers, x):
        x, kv = _shared_block(params["shared"], lora, x, cfg, tun,
                              positions=positions)
        states = []
        for p_l in layers:
            x, st = inner(p_l, x, cfg, tun)
            states.append(st)
        return x, kv, states
    outer = remat(outer, tun, x, params)
    for g, (lora, layers) in enumerate(zip(loras, groups)):
        x, (k, v), states = outer(lora, layers, x)
        if return_cache:
            cache["k"][g, :, :S] = k
            cache["v"][g, :, :S] = v
            for i, st in enumerate(states):
                _write_state(_layer_state(cache["g_ssm"], g, i), st)
    for i, p_l in enumerate(rest):
        x, st = inner(p_l, x, cfg, tun)
        if return_cache:
            _write_state(_layer_state(cache["r_ssm"], i), st)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux, (cache if return_cache else None)


def decode_zamba(params, cfg, batch, cache, tun):
    """One-token decode. batch: {"tokens": (B,1), "pos": an int or a
    0-dim int64 tensor on the device}; ``cache`` is updated IN PLACE (KV
    slot ``pos``, every SSD state) and returned."""
    x = params["embed"][batch["tokens"]]
    step = L.decode_positions(batch["pos"], cache["k"].shape[2], x.device)
    loras, groups, rest = _zamba_layers(params, cfg)
    for g, (lora, layers) in enumerate(zip(loras, groups)):
        x, _ = _shared_block(params["shared"], lora, x, cfg, tun,
                             kv=(cache["k"][g], cache["v"][g]), **step)
        for i, p_l in enumerate(layers):
            x = _step_into(p_l, x, cfg, _layer_state(cache["g_ssm"], g, i),
                           tun)
    for i, p_l in enumerate(rest):
        x = _step_into(p_l, x, cfg, _layer_state(cache["r_ssm"], i), tun)
    return _logits(params, cfg, x), cache


def cache_zamba(cfg, batch: int, seq: int, dtype=None, device=None):
    """Zeroed cache: per-layer SSD states (fp32 state, conv rows in the
    model dtype) and the shared block's k/v per group in ``dtype``
    (default: the model dtype) — the only tensors the cache dtype
    touches."""
    G, R = _zdims(cfg)
    dev = resolve_device(device)
    model_dt = _dtype(cfg)
    kv_shape = (G, batch, seq, cfg.n_kv_heads, cfg.hd)
    cache = {
        "g_ssm": M2.mamba2_init_state(cfg, batch, model_dt, device=dev,
                                      lead=(G, cfg.hybrid_period)),
        "k": torch.zeros(kv_shape, dtype=dtype or model_dt, device=dev),
        "v": torch.zeros(kv_shape, dtype=dtype or model_dt, device=dev),
    }
    if R:
        cache["r_ssm"] = M2.mamba2_init_state(cfg, batch, model_dt,
                                              device=dev, lead=(R,))
    return cache
