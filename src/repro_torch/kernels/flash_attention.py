"""GQA flash attention forward (causal/sliding-window, logit softcap).

Counterpart of ``repro/kernels/flash_attention.py``.  Every prefill on the
``attn_impl="pallas"`` route runs it once per layer:

* on a CUDA tensor ``flash_attention`` launches the hand-written kernel
  ``csrc/flash_attention.cu`` (which replaces the TPU kernel ``_kernel``)
  on the current stream, chosen by dtype: bf16 takes the tensor-core
  kernel (``wgmma``, K/V through a TMA ring), fp32 the CUDA-core kernel;
* on a CPU tensor it takes ``_flash_fwd_plain``, the same blocked online
  softmax in plain PyTorch: fp32 throughout, one (bk) KV tile at a time,
  with the reference's padding, masks and update formulas.

``bq``/``bk`` (default 128, capped at the sequence lengths) set the plain
version's tiles, as they set the reference's; the CUDA kernels keep their
own (64 query rows; 64 keys in bf16, 32 in fp32).  Tiles change only the
order of the sums, except for a query row that sees no key (a sliding
window past the last key): the reference averages v over its KV padded to
``bk``, and the kernel is told that padded length so it answers the same.

The public entry keeps the reference's quirks: a tensor ``window`` (the
per-layer scalar the transformer passes) becomes 0, and ``q_pos``/
``kv_pos`` are accepted and ignored (ROADMAP C4, C10).  It goes through
``FlashAttention``, a ``torch.autograd.Function``: the forward above, and
a backward that recomputes through ``models/layers.attention_xla`` and
differentiates that, as the reference's ``custom_vjp`` does
(``flash_attention.py:143-160``); there is no backward kernel, in the
reference or here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.dispatch import refuse_fake

NEG = -1e30

# launches of the CUDA kernel; the wrapper adds one per launch and nothing
# else touches it except callers resetting it to 0
LAUNCHES = 0
# the same launches by input dtype, and the kernel design each dtype takes
LAUNCHES_BY_DTYPE = {"bfloat16": 0, "float32": 0}
DESIGN = {"bfloat16": "wgmma", "float32": "cuda_cores"}

HEAD_DIMS = (32, 64, 112, 128, 224, 256)   # head widths the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# flash_attention_fwd(q, k, v, out, dtype, d, B, Sq, Skv, H, K, kv_len,
# kv_pad, 12 strides, causal, window, softcap, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p])


def _pad_seq(x, n: int):
    """Zero-pad axis 1 of (B, S, heads, d) by ``n`` rows."""
    if not n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n, *x.shape[2:]))], dim=1)


def _flash_fwd_plain(q, k, v, kv_len=None, *, causal=True, window=0,
                     softcap=0.0, bq=128, bk=128):
    """q: (B, Sq, H, d); k,v: (B, Skv, K, d) -> (B, Sq, H, d) in q's dtype.

    The reference's kernel in plain PyTorch: inputs padded to the tiles,
    ``kv_len`` defaulting to Skv when KV is padded, then for each KV tile
    s = (q·k)·d^-½ (softcapped), masked to −1e30, and the online-softmax
    update m_new = max(m, rowmax), p = exp(s − m_new), corr = exp(m − m_new).
    Query tiles are independent rows, so all of them advance together."""
    B, Sq, H, d = q.shape
    K = k.shape[2]
    G = H // K
    scale = d ** -0.5

    bq = min(bq, Sq)
    bk = min(bk, k.shape[1])
    kpad = (-k.shape[1]) % bk
    q = _pad_seq(q, (-Sq) % bq)
    if kpad:
        k, v = _pad_seq(k, kpad), _pad_seq(v, kpad)
        if kv_len is None:
            kv_len = k.shape[1] - kpad
    Sqp, Skvp = q.shape[1], k.shape[1]

    # (B, K, G, S, d): query head h = kh * G + g reads KV head kh
    qf = q.to(torch.float32).reshape(B, Sqp, K, G, d).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    q_pos = torch.arange(Sqp, device=q.device)[:, None]

    m = torch.full((B, K, G, Sqp, 1), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sqp, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, Skvp, bk):
        s = (qf @ kf[..., k0:k0 + bk, :].transpose(-1, -2)) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + bk, device=q.device)[None, :]
        ok = torch.ones((Sqp, bk), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (k_pos <= q_pos)
        if window is not None and window > 0:
            ok = ok & (k_pos > q_pos - window)
        if kv_len is not None:
            ok = ok & (k_pos < kv_len)
        s = torch.where(ok, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vf[..., k0:k0 + bk, :]
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sqp, H, d)
    return out[:, :Sq].to(q.dtype)


def _check_cuda_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                             f"{name} on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, heads, d), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k, v must share a dtype, got {q.dtype} "
                            f"and {t.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    B, _, H, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"query heads ({H}) must be a multiple of KV heads "
                         f"({k.shape[2]})")


def _tma_operand(t):
    """``t`` (or, where TMA cannot read it, a contiguous copy) and its
    (batch, sequence, head) strides in elements.  TMA needs a contiguous
    last axis, a 16-byte aligned base and strides that are multiples of
    16 bytes (8 bf16); a size-1 axis, whose stride nothing reads, gets the
    tensor's span instead."""
    (s0, s1, s2, s3), (n0, n1, n2, _) = t.stride(), t.shape
    if (s3 != 1 or t.data_ptr() & 15 or (s0 & 7 and n0 > 1)
            or (s1 & 7 and n1 > 1) or (s2 & 7 and n2 > 1)):
        t = t.clone(memory_format=torch.contiguous_format)
        s0, s1, s2, s3 = t.stride()
    if n0 > 1 and n1 > 1 and n2 > 1:
        return t, (s0, s1, s2)
    st, sh = t.stride(), t.shape
    span = max(s_ * n for s_, n in zip(st, sh))
    span += (-span) % 8
    return t, tuple(s_ if n > 1 else span for s_, n in zip(st[:3], sh[:3]))


def _flash_fwd_cuda(q, k, v, kv_len=None, *, causal=True, window=0,
                    softcap=0.0, bk=128):
    """Launch ``csrc/flash_attention.cu`` on the current stream.  Reads
    (B, S, heads, d) through strides (the last axis must be contiguous,
    and in bf16 the base and strides 16-byte aligned for TMA, else that
    tensor is copied); writes a new (B, Sq, H, d) tensor.
    ``bk`` only sets the padded KV length that rows seeing no key divide
    by, as the reference's tile does."""
    global LAUNCHES
    refuse_fake(q, k, v)
    _check_cuda_inputs(q, k, v)
    if q.dtype == torch.bfloat16:
        (q, qs), (k, ks), (v, vs) = (_tma_operand(t) for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
        qs, ks, vs = (t.stride()[:3] for t in (q, k, v))
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    kv_len = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
    bk = min(bk, Skv)
    kv_pad = Skv + (-Skv) % bk if bk else 0
    fn = cuda_build.function("flash_attention", "flash_attention_fwd",
                             _ARGTYPES)
    strides = (*qs, *ks, *vs, *out.stride()[:3])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], d, B, Sq, Skv, H, K, kv_len, kv_pad,
                 *strides,
                 int(bool(causal)), int(window or 0), float(softcap),
                 float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(q.dtype)[6:]] += 1
    return out


def _flash_fwd(q, k, v, kv_len=None, *, causal=True, window=0, softcap=0.0,
               bq=128, bk=128):
    """q: (B, Sq, H, d); k,v: (B, Skv, K, d) -> (B, Sq, H, d).  The kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, kv_len, causal=causal, window=window,
                               softcap=softcap, bk=bk)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention route for {q.device}")
    return _flash_fwd_plain(q, k, v, kv_len, causal=causal, window=window,
                            softcap=softcap, bq=bq, bk=bk)


def _ref(q, k, v, causal, window, softcap):
    """The backward's oracle, the reference's ``_ref``: ``attention_xla``
    over the whole sequence (``kernels/ref.attention_ref``)."""
    from repro_torch.kernels.ref import attention_ref
    return attention_ref(q, k, v, causal=causal, window=window or None,
                         softcap=softcap)


class FlashAttention(torch.autograd.Function):
    """Forward: ``_flash_fwd`` (the kernel on a CUDA tensor, the plain
    version on a CPU tensor).  Backward: ``_ref`` recomputed on detached
    copies of the saved q, k, v and differentiated by autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap)
        return _flash_fwd(q, k, v, causal=causal, window=window,
                          softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
            out = _ref(*qkv, *ctx.opts)
            wrt = [t for t in qkv if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if t.requires_grad else None for t in qkv),
                None, None, None)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=0.0,
                    q_pos=None, kv_pos=None):
    """Public entry, with the reference's signature.  A tensor ``window``
    is dropped (0 = full attention) and ``q_pos``/``kv_pos`` are ignored,
    exactly as the reference does."""
    w = int(window) if window is not None and not hasattr(window, "shape") \
        else 0
    return FlashAttention.apply(q, k, v, bool(causal), w, float(softcap))
