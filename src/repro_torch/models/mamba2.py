"""Mamba2 (SSD — state-space duality) mixer, chunked-scan formulation.

Port of ``repro/models/mamba2.py``.  Prefill uses the chunked SSD
algorithm (batched intra-chunk matmuls + the inter-chunk state recurrence
as a Python loop over chunks, where the reference scans); decode uses the
O(1) recurrent state update.  ``impl="pallas"`` routes the chunk
computation to ``kernels/ssd_scan.py`` (the hand-written CUDA kernel on a
CUDA tensor, its plain version on the CPU); ``ssd_chunked`` here is the
XLA route and the kernel's oracle.  In decode, ``impl="pallas"`` on CUDA
tensors routes the mixer between its two projections to
``kernels/ssm_step.py`` (a fused CUDA kernel pair that updates the cache
in place); ``mixer_step`` here is its oracle and every other route.

Both routes return the mixer's output in the input's dtype: the kernel's
fp32 ``y`` is cast to ``x.dtype`` where ``ssd_chunked`` casts
(``mamba2.py:99``).  The reference's pallas route does not cast, so at
bfloat16 its layer output turns fp32 and its layer scan raises (ROADMAP
C12); at fp32 the cast is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as K
from repro_torch.kernels import ssm_step as SS
from repro_torch.kernels.dispatch import takes_kernels
from repro_torch.models import layers as L


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, H, conv_dim


def mamba2_init(gen, cfg, dtype, lead=()):
    """One mixer's parameters, with ``lead`` stacked axes (the layer axes)
    in front of each leaf, drawn from ``gen`` on ``gen.device``."""
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, conv_dim = _dims(cfg)
    dev = gen.device

    def full(shape, value, dt):
        return torch.full((*lead, *shape), value, dtype=dt, device=dev)
    A_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    return {
        "in_proj": L.dense_init(gen, D, 2 * d_inner + 2 * s.n_groups
                                * s.d_state + H, dtype, lead=lead),
        "conv_w": (L._normal(gen, (*lead, s.d_conv, 1, conv_dim)) * 0.1
                   ).to(dtype),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "A_log": A_log.expand(*lead, H).clone(),
        "D_skip": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "norm": full((d_inner,), 0.0, dtype),
        "out_proj": L.dense_init(gen, d_inner, D, dtype, lead=lead),
    }


# ---------------------------------------------------------------------------
# chunked SSD (XLA route)
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """x: (B,S,H,P) dt: (B,S,H) A: (H,) Bm/Cm: (B,S,G,N) -> y (B,S,H,P) in
    x's dtype, final state (B,H,N,P) fp32."""
    Bs, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    r = H // G
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    f32 = torch.float32

    xb = x.reshape(Bs, nc, chunk, H, P).to(f32)
    dtb = dt.reshape(Bs, nc, chunk, H).to(f32)
    Bb = Bm.reshape(Bs, nc, chunk, G, N).to(f32)
    Cb = Cm.reshape(Bs, nc, chunk, G, N).to(f32)

    a = dtb * A                                             # (B,nc,Q,H)
    cum = torch.cumsum(a, dim=2)
    cum_h = cum.transpose(2, 3)                             # (B,nc,H,Q)

    # intra-chunk (quadratic within the chunk)
    CB = K.repeat_groups(torch.einsum("bcigN,bcjgN->bcgij", Cb, Bb), r, 2)
    diff = cum_h[..., :, None] - cum_h[..., None, :]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # mask BEFORE exp: upper-triangle differences are positive and would
    # overflow
    Lmat = torch.exp(torch.where(tril, diff, L.NEG))
    scores = CB * Lmat * dtb.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, xb)

    # per-chunk end states
    dec_end = torch.exp(cum_h[..., -1:] - cum_h)            # (B,nc,H,Q)
    Bh = K.repeat_groups(Bb, r, 3)                          # (B,nc,Q,H,N)
    w = dec_end.transpose(2, 3) * dtb                       # (B,nc,Q,H)
    S_c = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", w, Bh, xb)

    # inter-chunk recurrence: the state before each chunk
    tot = torch.exp(cum_h[..., -1])                         # (B,nc,H)
    state = torch.zeros((Bs, H, N, P), dtype=f32, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * tot[:, c, :, None, None] + S_c[:, c]
    S_prevs = torch.stack(prevs, dim=1)                     # (B,nc,H,N,P)

    Ch = K.repeat_groups(Cb, r, 3)
    y_inter = torch.einsum("bcih,bcihn,bchnp->bcihp", torch.exp(cum), Ch,
                           S_prevs)
    y = (y_intra + y_inter).reshape(Bs, S, H, P)
    return y.to(x.dtype), state


def ssd_step(state, x, dt, A, Bm, Cm):
    """Single-token recurrence. state: (B,H,N,P); x: (B,H,P); dt: (B,H);
    Bm/Cm: (B,G,N).  Returns (new state, y (B,H,P)), both fp32."""
    H = x.shape[1]
    G = Bm.shape[1]
    r = H // G
    f32 = torch.float32
    x, dt, Bm, Cm = (t.to(f32) for t in (x, dt, Bm, Cm))
    Bh = K.repeat_groups(Bm, r, 1)
    Ch = K.repeat_groups(Cm, r, 1)
    decay = torch.exp(dt * A)                               # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt, Bh, x)
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    return state, y


# ---------------------------------------------------------------------------
# the full mixer block
# ---------------------------------------------------------------------------


def _silu(x):
    """x * sigmoid(x), as ``jax.nn.silu`` computes it: at bfloat16 the
    sigmoid is rounded before the product (``F.silu`` rounds once)."""
    return x * torch.sigmoid(x)


def _conv_full(xBC, w, b):
    """Causal depthwise conv over time, then SiLU.  xBC: (B,S,Cd);
    w: (k,1,Cd) — the reference's WIO layout.  k shifted products summed
    in fp32 and rounded once to the input's dtype, as a convolution
    accumulates (no cuDNN, so no TF32 on the card)."""
    k, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0)).to(torch.float32)
    wf = w[:, 0].to(torch.float32)
    out = pad[:, :S] * wf[0]
    for m in range(1, k):
        out = out + pad[:, m:m + S] * wf[m]
    return _silu(out.to(xBC.dtype) + b)


def _split_proj(zxbcdt, cfg):
    d_inner, H, conv_dim = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)


def mamba2_apply(p, x, cfg, *, chunk: int | None = None, impl: str = "xla"):
    """Prefill path. x: (B,S,D) -> (out (B,S,D), {"ssm": final state
    (B,H,N,P) fp32, "conv": the last k-1 pre-conv rows (B,k-1,Cd)})."""
    s = cfg.ssm
    B, S, D = x.shape
    d_inner, H, conv_dim = _dims(cfg)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    chunk = min(chunk or s.chunk, S)
    while S % chunk:
        chunk //= 2

    z, xBC, dt = _split_proj(x @ p["in_proj"], cfg)
    conv_tail = xBC[:, S - (s.d_conv - 1):, :]      # raw pre-conv, for decode
    xBC = _conv_full(xBC, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if takes_kernels(impl):
        y, S_last = K.ssd(xs, dt, A, Bm, Cm, chunk=chunk)
        y = y.to(x.dtype)                           # ROADMAP C12
    else:
        y, S_last = ssd_chunked(xs, dt, A, Bm, Cm, chunk)
    y = y + (p["D_skip"][:, None] * xs.to(torch.float32)).to(y.dtype)

    y = y.reshape(B, S, d_inner)
    y = L.rmsnorm(y * _silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"ssm": S_last, "conv": conv_tail}


def mamba2_step(p, x, cfg, state, *, impl: str = "xla"):
    """Decode path. x: (B,1,D); state: {"ssm": (B,H,N,P), "conv":
    (B,k-1,Cd)}.  Returns (out (B,1,D), new state).  With
    ``impl="pallas"`` on CUDA tensors the fused kernel
    (``kernels/ssm_step.py``) updates ``state``'s tensors in place and
    ``state`` itself is returned; it raises on inputs it does not take.
    Any other ``impl``, and any CPU tensor, runs ``mixer_step``, which
    returns new tensors."""
    zxbcdt = (x @ p["in_proj"])[:, 0]
    args = (zxbcdt, state["conv"], state["ssm"], p["conv_w"], p["conv_b"],
            p["dt_bias"], p["A_log"], p["D_skip"], p["norm"])
    if takes_kernels(impl) and zxbcdt.is_cuda:
        y, new = SS.ssm_step(*args, eps=cfg.norm_eps), state
    else:
        y, new = mixer_step(*args, eps=cfg.norm_eps)
    return y[:, None] @ p["out_proj"], new


def mixer_step(zxbcdt, conv, ssm, conv_w, conv_b, dt_bias, A_log, D_skip,
               norm, *, eps: float):
    """The plain decode step of one mixer between its two projections,
    with the arguments of ``kernels/ssm_step.ssm_step`` and its oracle:
    zxbcdt (B, 2 d_inner + 2 G N + H), conv (B, k-1, Cd), ssm (B, H, N, P).
    Returns (the normalised gated output (B, d_inner) in zxbcdt's dtype,
    {"ssm", "conv"} new tensors)."""
    B, H, N, P = ssm.shape
    d_inner = H * P
    G = (conv.shape[2] - d_inner) // (2 * N)
    z, xBC, dt = torch.split(zxbcdt, [d_inner, conv.shape[2], H], dim=-1)
    hist = torch.cat([conv, xBC[:, None, :].to(conv.dtype)], dim=1)  # (B,k,Cd)
    w = conv_w[:, 0, :]                                      # (k,Cd)
    xBC = _silu(torch.einsum("bkc,kc->bc", hist, w) + conv_b)
    new_conv = hist[:, 1:]

    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + dt_bias)
    A = -torch.exp(A_log)
    new_ssm, y = ssd_step(ssm, xs.reshape(B, H, P), dt, A,
                          Bm.reshape(B, G, N), Cm.reshape(B, G, N))
    y = y + D_skip[:, None] * xs.reshape(B, H, P).to(torch.float32)
    y = y.reshape(B, d_inner).to(zxbcdt.dtype)
    y = L.rmsnorm(y * _silu(z), norm, eps)
    return y, {"ssm": new_ssm, "conv": new_conv}


def mamba2_init_state(cfg, batch: int, dtype, device=None, lead=()):
    """Zeroed decode state: ssm (B,H,N,P) fp32, conv (B,k-1,Cd) in
    ``dtype``, with ``lead`` stacked axes in front."""
    s = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((*lead, batch, H, s.d_state, s.head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, s.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
    }
