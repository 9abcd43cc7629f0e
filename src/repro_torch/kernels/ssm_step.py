"""One Mamba2 mixer's decode step, fused: conv step, in-place SSD state
update and gated RMSNorm.

Replaces no TPU kernel: the reference decodes through plain XLA ops
(``repro/models/mamba2.py``: ``mamba2_step``, ``ssd_step``).  On the
``attn_impl="pallas"`` route ``models/mamba2.mamba2_step`` hands this
wrapper a layer's in_proj output row and cache views whenever they are
CUDA tensors; ``models/mamba2.mixer_step``, which takes the same
arguments, is its oracle and the CPU's route.

``ssm_step`` launches ``csrc/ssm_step.cu`` on the current stream, two
kernels: ``ssm_decode_step`` (grid: batch rows x heads x 16-column
slices of P) and ``ssm_decode_norm`` (the RMSNorm over ``d_inner``, which
reduces across heads, and the shift of the conv rows).  It updates
``ssm`` and ``conv`` IN PLACE and returns the normalised, gated mixer
output (B, d_inner) in the model dtype, ready for ``out_proj``.  It reads
no value on the host and allocates only its output and scratch with
``torch.empty``, so a CUDA graph can capture it.

What it takes (any other input raises): CUDA tensors, contiguous;
``zxbcdt`` (B, 2 d_inner + 2 G N + H), ``conv`` (B, K - 1, d_inner + 2 G
N), ``conv_w`` (K, 1, d_inner + 2 G N), ``conv_b`` (d_inner + 2 G N,) and
``norm`` (d_inner,) in one of fp32 and bf16; ``ssm`` (B, H, N, P),
``dt_bias``, ``A_log``, ``D_skip`` (H,) in fp32; P a multiple of 16, N
at most 128, G dividing H, 2 <= K <= 8.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build, dispatch

# calls of the wrapper, two kernel launches each; the wrapper adds one per
# call and nothing else touches it except callers resetting it to 0 (a
# replayed CUDA graph runs the kernels without calling the wrapper)
LAUNCHES = 0

COLS = 16          # P columns a block of ssm_decode_step owns
MAX_STATE = 128    # largest d_state N
MAX_CONV = 8       # largest d_conv K
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# ssm_decode(zx, conv, state, conv_w, conv_b, dt_bias, A_log, D_skip,
#            norm, out, part, dtype, B, H, P, G, N, K, eps, stream)
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


def _check(zxbcdt, conv, ssm, conv_w, conv_b, dt_bias, A_log, D_skip,
           norm) -> tuple:
    """(B, H, P, G, N, K) of inputs the kernel takes; raises otherwise."""
    named = (("zxbcdt", zxbcdt), ("conv", conv), ("ssm", ssm),
             ("conv_w", conv_w), ("conv_b", conv_b), ("dt_bias", dt_bias),
             ("A_log", A_log), ("D_skip", D_skip), ("norm", norm))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                             f"{name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel needs contiguous inputs; "
                             f"{name} has strides {t.stride()}")
    dispatch.refuse_fake(*(t for _, t in named))
    dt = zxbcdt.dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in
                                (conv, conv_w, conv_b, norm)):
        raise TypeError(f"zxbcdt, conv, conv_w, conv_b and norm must share "
                        f"float32 or bfloat16, got {zxbcdt.dtype}, "
                        f"{conv.dtype}, {conv_w.dtype}, {conv_b.dtype}, "
                        f"{norm.dtype}")
    if any(t.dtype != torch.float32 for t in (ssm, dt_bias, A_log, D_skip)):
        raise TypeError("ssm, dt_bias, A_log and D_skip must be float32")
    if ssm.dim() != 4 or conv.dim() != 3 or conv_w.dim() != 3 \
            or zxbcdt.dim() != 2:
        raise ValueError(f"expected zxbcdt (B, W), conv (B, K-1, Cd), ssm "
                         f"(B, H, N, P), conv_w (K, 1, Cd); got "
                         f"{tuple(zxbcdt.shape)}, {tuple(conv.shape)}, "
                         f"{tuple(ssm.shape)}, {tuple(conv_w.shape)}")
    B, H, N, P = ssm.shape
    K, Cd = conv.shape[1] + 1, conv.shape[2]
    DI = H * P
    GN2 = Cd - DI
    G = GN2 // (2 * N) if N else 0
    if (GN2 <= 0 or G * 2 * N != GN2 or zxbcdt.shape != (B, DI + Cd + H)
            or conv.shape[0] != B or conv_w.shape != (K, 1, Cd)
            or conv_b.shape != (Cd,) or norm.shape != (DI,)
            or any(t.shape != (H,) for t in (dt_bias, A_log, D_skip))):
        raise ValueError(f"shapes do not match one mixer: zxbcdt "
                         f"{tuple(zxbcdt.shape)}, conv {tuple(conv.shape)}, "
                         f"ssm {tuple(ssm.shape)}, conv_w "
                         f"{tuple(conv_w.shape)}, conv_b "
                         f"{tuple(conv_b.shape)}, norm {tuple(norm.shape)}")
    if P % COLS:
        raise ValueError(f"the CUDA kernel takes head_dim P a multiple of "
                         f"{COLS}, got {P}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"the CUDA kernel takes 1 <= d_state N <= "
                         f"{MAX_STATE}, got {N}")
    if H % G:
        raise ValueError(f"heads ({H}) must be a multiple of groups ({G})")
    if not 2 <= K <= MAX_CONV:
        raise ValueError(f"the CUDA kernel takes 2 <= d_conv <= {MAX_CONV}, "
                         f"got {K}")
    if not 1 <= B <= 65535:
        raise ValueError(f"the CUDA kernel takes 1 <= batch <= 65535, got {B}")
    if ssm.data_ptr() % 16:
        raise ValueError("the CUDA kernel reads the state as 16-byte "
                         "vectors: ssm must be 16-byte aligned")
    return B, H, P, G, N, K


def ssm_step(zxbcdt, conv, ssm, conv_w, conv_b, dt_bias, A_log, D_skip,
             norm, *, eps: float):
    """One decode step of one mixer: ``ssm`` and ``conv`` updated in place;
    returns the normalised gated output (B, d_inner) in zxbcdt's dtype."""
    global LAUNCHES
    B, H, P, G, N, K = _check(zxbcdt, conv, ssm, conv_w, conv_b, dt_bias,
                              A_log, D_skip, norm)
    out = torch.empty((B, H * P), dtype=zxbcdt.dtype, device=zxbcdt.device)
    part = torch.empty((B, H * (P // COLS)), dtype=torch.float32,
                       device=zxbcdt.device)
    fn = cuda_build.function("ssm_step", "ssm_decode", _ARGTYPES)
    with torch.cuda.device(zxbcdt.device):
        err = fn(zxbcdt.data_ptr(), conv.data_ptr(), ssm.data_ptr(),
                 conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
                 A_log.data_ptr(), D_skip.data_ptr(), norm.data_ptr(),
                 out.data_ptr(), part.data_ptr(), _DTYPES[zxbcdt.dtype], B,
                 H, P, G, N, K, float(eps),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_step launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
