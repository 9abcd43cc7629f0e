"""Shared model building blocks: norms, RoPE, GQA attention, MLP.

Port of ``repro/models/layers.py``.  Params are plain dicts of tensors.
Layer stacks carry a leading ``L`` axis (the reference's scan layout), and
every projection is ``x @ W`` with ``W`` shaped (d_in, d_out), so the
reference's parameters convert leaf by leaf (``repro_torch.convert``).

Attention has two implementations, chosen by ``dispatch.takes_kernels``
of the ``attn_impl`` tunable:
  * ``xla``    — chunked (query-blocked) plain PyTorch attention, the
                 counterpart of the reference's XLA path and the kernel's
                 oracle;
  * ``pallas`` — ``kernels/flash_attention.py``: the hand-written CUDA
                 kernel on a CUDA tensor, its plain version on the CPU.

Every family decodes against its KV cache through ``attn_decode``.

Init helpers draw from an explicit ``torch.Generator`` where the reference
splits ``jax.random`` keys; the two give different numbers, so tests
convert the reference's parameters instead of re-drawing them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import takes_kernels

NEG = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen, d_in: int, d_out, dtype, scale: float | None = None,
               lead=()):
    """Normal(0, scale) init; scale defaults to 1/sqrt(d_in).  ``lead``
    prepends stacked axes (the layer axis)."""
    if scale is None:
        scale = d_in ** -0.5
    shape = (d_in, d_out) if isinstance(d_out, int) else (d_in, *d_out)
    # scaled in place: a stacked fp32 draw (zamba2-7b's in_proj is 16 GB)
    # is not held twice
    return _normal(gen, (*lead, *shape)).mul_(scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype):
    return (_normal(gen, (vocab, d)) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    # torch.full, not torch.tensor: a scalar copied to the card from the
    # host would synchronize the stream
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                     device=x.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv           # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                            # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masked GQA attention (chunked plain path)
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, kv_pos, *, causal: bool, window, prefix_len: int,
               kv_len=None):
    """(Sq, Skv) additive bias in f32. ``window`` may be a 0-dim tensor
    (0 = full attention); ``kv_len`` masks unfilled cache slots."""
    iq = q_pos[:, None]
    jk = kv_pos[None, :]
    ok = torch.ones((iq.shape[0], jk.shape[1]), dtype=torch.bool,
                    device=iq.device)
    if causal:
        c = jk <= iq
        if prefix_len:
            c = c | ((iq < prefix_len) & (jk < prefix_len))
        ok = ok & c
    if window is not None:
        w = torch.as_tensor(window, dtype=torch.int32, device=iq.device)
        ok = ok & ((w == 0) | (jk > iq - w))
    if kv_len is not None:
        ok = ok & (jk < kv_len)
    return torch.where(ok, 0.0, NEG).to(torch.float32)


def _attn_block_impl(q, k, v, bias, softcap: float, scale: float):
    """q: (B,Sq,K,G,D)  k,v: (B,Skv,K,D)  bias: (Sq,Skv).  Scores in f32;
    probabilities cast to v's dtype before the second product, as the
    reference does."""
    s = torch.einsum("bqkgd,btkd->bkgqt", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s + bias[None, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", p, v)


def _attn_block(q, k, v, bias, *, softcap: float, scale: float):
    """``_attn_block_impl``; while grad is enabled and q, k or v needs it,
    under ``torch.utils.checkpoint`` with nothing saved but the inputs:
    the O(Sq·Skv) scores and probabilities are recomputed in the backward,
    never stored (the reference's ``nothing_saveable`` remat,
    ``layers.py:105-114``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return checkpoint(_attn_block_impl, q, k, v, bias, softcap, scale,
                          use_reentrant=False)
    return _attn_block_impl(q, k, v, bias, softcap, scale)


def attention_xla(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
                  prefix_len=0, softcap=0.0, kv_len=None, q_chunk=1024):
    """Chunked GQA attention: one query chunk of ``q_chunk`` rows at a
    time (a Python loop where the reference scans).

    q: (B,Sq,H,D); k,v: (B,Skv,K,D); H % K == 0. Returns (B,Sq,H,D).
    """
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = D ** -0.5
    qg = q.reshape(B, Sq, K, G, D)

    if Sq <= q_chunk:
        bias = _mask_bias(q_pos, kv_pos, causal=causal, window=window,
                          prefix_len=prefix_len, kv_len=kv_len)
        out = _attn_block(qg, k, v, bias, softcap=softcap, scale=scale)
        return out.reshape(B, Sq, H, D)

    assert Sq % q_chunk == 0, (Sq, q_chunk)
    outs = []
    for i in range(Sq // q_chunk):
        sl = slice(i * q_chunk, (i + 1) * q_chunk)
        bias = _mask_bias(q_pos[sl], kv_pos, causal=causal, window=window,
                          prefix_len=prefix_len, kv_len=kv_len)
        outs.append(_attn_block(qg[:, sl], k, v, bias, softcap=softcap,
                                scale=scale))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# attention block (projection + rope + attention)
# ---------------------------------------------------------------------------


def attn_init(gen, cfg, dtype, lead=()):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, D, H * hd, dtype, lead=lead),
        "wk": dense_init(gen, D, K * hd, dtype, lead=lead),
        "wv": dense_init(gen, D, K * hd, dtype, lead=lead),
        "wo": dense_init(gen, H * hd, D, dtype, lead=lead),
    }

    def zeros(n):
        return torch.zeros((*lead, n), dtype=dtype, device=gen.device)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(H * hd), zeros(K * hd), zeros(K * hd)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(hd), zeros(hd)
    return p


def attn_qkv(p, x, cfg, positions):
    """Project + rope; returns q (B,S,H,hd), k, v (B,S,K,hd)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg, *, positions, causal=True, window=None,
               prefix_len=0, q_chunk=1024, impl="xla"):
    """Self-attention block over x.  ``impl`` is the ``attn_impl``
    tunable: ``"pallas"`` routes to ``kernels/flash_attention.py``,
    which, like the reference's, ignores ``prefix_len`` and any tensor
    ``window`` (ROADMAP C4, C10)."""
    B, S, _ = x.shape
    q, k, v = attn_qkv(p, x, cfg, positions)
    if takes_kernels(impl):
        from repro_torch.kernels import flash_attention as fa
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cfg.attn_softcap, q_pos=positions,
                                 kv_pos=positions)
    else:
        out = attention_xla(q, k, v, q_pos=positions, kv_pos=positions,
                            causal=causal, window=window, prefix_len=prefix_len,
                            softcap=cfg.attn_softcap, q_chunk=q_chunk)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd).to(x.dtype)
    return out @ p["wo"], (k, v)


def decode_positions(pos, S: int, device) -> dict:
    """A decode step's ``positions`` (1,), ``kv_pos`` over the cache's S
    slots and ``kv_len`` (pos + 1) from ``pos``, an int or a 0-dim int64
    device tensor, with no host read: an int becomes a device scalar
    first, so a CUDA graph can capture the step with ``pos`` on the
    device."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int64, device=device)
    return dict(positions=pos.view(1), kv_pos=torch.arange(S, device=device),
                kv_len=pos + 1)


def attn_decode(p, x, cfg, kv, *, positions, kv_pos, kv_len, slot=None,
                window=None, prefix_len=0, softcap=0.0):
    """The attention block of one decode step against the cache ``kv`` =
    (ck, cv), (B, S, K, hd) each: this token's key and value written IN
    PLACE at ``slot`` (default ``positions``) with ``index_copy_``, cast
    to the cache's dtype, then attention masked to ``kv_len`` (one query
    row: one chunk) and ``wo``."""
    q, k, v = attn_qkv(p, x, cfg, positions)
    ck, cv = kv
    slot = positions if slot is None else slot
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    out = attention_xla(q, ck, cv, q_pos=positions, kv_pos=kv_pos,
                        window=window, prefix_len=prefix_len,
                        softcap=softcap, kv_len=kv_len)
    out = out.reshape(x.shape[0], 1, cfg.n_heads * cfg.hd).to(x.dtype)
    return out @ p["wo"]


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen, d: int, f: int, dtype, lead=()):
    return {
        "wi": dense_init(gen, d, f, dtype, lead=lead),
        "wg": dense_init(gen, d, f, dtype, lead=lead),
        "wo": dense_init(gen, f, d, dtype, lead=lead),
    }


def mlp_apply(p, x):
    h = F.silu(x @ p["wg"])
    h = h * (x @ p["wi"])
    return h @ p["wo"]


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x
