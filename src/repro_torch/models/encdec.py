"""Encoder-decoder transformer (seamless-m4t family).

Port of ``repro/models/encdec.py``.  The speech frontend is a STUB:
``input_specs()`` supplies precomputed frame embeddings (B, S_src,
d_model); a linear ``frame_proj`` stands in for the modality adaptor.
Decoder layers: causal self-attention + cross-attention to the encoder
memory + MLP.  Prefill caches both self-KV and cross-KV.

Attention is always ``attention_xla`` (the reference never passes
``impl`` here), so the ``attn_impl`` tunable changes nothing and no
kernel runs.  Layer bodies run under the ``remat`` policy as the other
families' do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import _dtype, _unstack, remat


def enc_layer_init(gen, cfg, dtype, lead=()):
    return {"ln1": torch.zeros((*lead, cfg.d_model), dtype=dtype,
                               device=gen.device),
            "attn": L.attn_init(gen, cfg, dtype, lead=lead),
            "ln2": torch.zeros((*lead, cfg.d_model), dtype=dtype,
                               device=gen.device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, lead=lead)}


def dec_layer_init(gen, cfg, dtype, lead=()):
    p = enc_layer_init(gen, cfg, dtype, lead)
    p["lnx"] = torch.zeros((*lead, cfg.d_model), dtype=dtype,
                           device=gen.device)
    p["xattn"] = L.attn_init(gen, cfg, dtype, lead=lead)
    return p


def init(gen: torch.Generator, cfg):
    """Parameters drawn from ``gen`` on ``gen.device``."""
    dtype = _dtype(cfg)
    return {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "frame_proj": L.dense_init(gen, cfg.d_model, cfg.d_model, dtype),
        "enc_layers": enc_layer_init(gen, cfg, dtype, (cfg.enc_layers,)),
        "enc_ln_f": torch.zeros((cfg.d_model,), dtype=dtype,
                                device=gen.device),
        "dec_layers": dec_layer_init(gen, cfg, dtype, (cfg.n_layers,)),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
    }


def _cross_kv(p, mem, cfg):
    """The encoder memory's cross-attention keys and values."""
    shape = (*mem.shape[:2], cfg.n_kv_heads, cfg.hd)
    return (mem @ p["wk"]).reshape(shape), (mem @ p["wv"]).reshape(shape)


def _cross_attn(p, x, xk, xv, cfg, q_chunk=1024):
    """Cross-attention: queries from x over the memory's keys/values."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    out = L.attention_xla(q, xk, xv, q_pos=torch.arange(S, device=x.device),
                          kv_pos=torch.arange(xk.shape[1], device=x.device),
                          causal=False, q_chunk=q_chunk)
    return out.reshape(B, S, H * hd).to(x.dtype) @ p["wo"]


def encode(params, cfg, frames, tun):
    x = frames.to(params["frame_proj"].dtype) @ params["frame_proj"]
    positions = torch.arange(x.shape[1], device=x.device)

    def body(p_l, x):
        h, _ = L.attn_apply(p_l["attn"], L.rmsnorm(x, p_l["ln1"], cfg.norm_eps),
                            cfg, positions=positions, causal=False,
                            q_chunk=tun.attn_q_chunk)
        x = x + h
        return x + L.mlp_apply(p_l["mlp"],
                               L.rmsnorm(x, p_l["ln2"], cfg.norm_eps))
    body = remat(body, tun, x, params["enc_layers"])
    for p_l in _unstack(params["enc_layers"], cfg.enc_layers):
        x = body(p_l, x)
    return L.rmsnorm(x, params["enc_ln_f"], cfg.norm_eps)


def forward(params, cfg, batch, tun, *, return_cache=False, cache=None):
    """Train/prefill: encode frames, run decoder over tokens.  Returns
    (logits, aux = 0, cache|None).

    With ``return_cache`` the decoder's self-attention keys and values go
    into ``cache["k"/"v"]`` ((L, B, capacity, K, hd), capacity >= S) at
    positions [0, S), and the cross-attention keys and values of the
    encoder memory into ``cache["xk"/"xv"]``, whose length must be the
    memory's; without a cache, one of exactly those lengths is
    allocated."""
    mem = encode(params, cfg, batch["frames"], tun)
    x = params["embed"][batch["tokens"]]
    S, T = x.shape[1], mem.shape[1]
    if return_cache and cache is None:
        cache = init_cache(cfg, x.shape[0], 2 * T, self_len=S,
                           device=x.device)
    positions = torch.arange(S, device=x.device)

    def body(p_l, x):
        h, kv = L.attn_apply(p_l["attn"],
                             L.rmsnorm(x, p_l["ln1"], cfg.norm_eps), cfg,
                             positions=positions, causal=True,
                             q_chunk=tun.attn_q_chunk)
        x = x + h
        xkv = _cross_kv(p_l["xattn"], mem, cfg)
        x = x + _cross_attn(p_l["xattn"],
                            L.rmsnorm(x, p_l["lnx"], cfg.norm_eps), *xkv,
                            cfg, tun.attn_q_chunk)
        x = x + L.mlp_apply(p_l["mlp"], L.rmsnorm(x, p_l["ln2"], cfg.norm_eps))
        return x, kv, xkv
    body = remat(body, tun, x, params["dec_layers"])
    for i, p_l in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        x, (k, v), (xk, xv) = body(p_l, x)
        if return_cache:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            cache["xk"][i] = xk
            cache["xv"][i] = xv
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ params["embed"].T
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, (cache if return_cache else None)


def decode_step(params, cfg, batch, cache, tun):
    """One-token decode. batch: {"tokens": (B,1), "pos": an int or a
    0-dim int64 tensor on the device}.  Writes this token's
    self-attention key and value IN PLACE at slot pos of the cache's S
    positions, clamped to S - 1 on the device as the reference's
    ``lax.dynamic_update_slice`` clamps its start index, and attends with
    ``kv_len = pos + 1``.  Returns (logits, cache)."""
    x = params["embed"][batch["tokens"]]
    S = cache["k"].shape[2]
    step = L.decode_positions(batch["pos"], S, x.device)
    slot = step["positions"].clamp(max=S - 1)
    layers = _unstack(params["dec_layers"], cfg.n_layers)
    for i, p_l in enumerate(layers):
        x = x + L.attn_decode(p_l["attn"],
                              L.rmsnorm(x, p_l["ln1"], cfg.norm_eps), cfg,
                              (cache["k"][i], cache["v"][i]), slot=slot,
                              **step)
        x = x + _cross_attn(p_l["xattn"],
                            L.rmsnorm(x, p_l["lnx"], cfg.norm_eps),
                            cache["xk"][i], cache["xv"][i], cfg)
        x = x + L.mlp_apply(p_l["mlp"], L.rmsnorm(x, p_l["ln2"], cfg.norm_eps))
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["embed"].T, cache


def init_cache(cfg, batch: int, seq: int, dtype=None, device=None,
               self_len: int | None = None):
    """Zeroed cache for a batch of ``seq`` positions, half frames and half
    tokens (the reference's layout): self-attention ``k``/``v`` of
    ``self_len`` positions (default seq // 2) in ``dtype`` (default: the
    model dtype), cross-attention ``xk``/``xv`` of the seq // 2 memory
    positions in the model dtype, each (L, batch, positions, K, hd), on
    ``device`` (None: CUDA)."""
    mdt = _dtype(cfg)
    dtype = dtype or mdt
    dev = resolve_device(device)
    half = seq // 2
    n = half if self_len is None else self_len

    def zeros(length, dt):
        return torch.zeros((cfg.n_layers, batch, length, cfg.n_kv_heads,
                            cfg.hd), dtype=dt, device=dev)
    return {"k": zeros(n, dtype), "v": zeros(n, dtype),
            "xk": zeros(half, mdt), "xv": zeros(half, mdt)}
