"""Mamba2 SSD chunked scan (state-space duality), forward.

Counterpart of ``repro/kernels/ssd_scan.py``.  Every prefill of the ``ssm``
and ``hybrid`` families on the ``attn_impl="pallas"`` route runs it once
per SSD layer:

* on a CUDA tensor ``ssd`` launches the hand-written kernel
  ``csrc/ssd_scan.cu`` (which replaces the TPU kernel ``_kernel``) on the
  current stream, chosen by the dtype of x, Bm, Cm: bf16 takes the
  tensor-core kernel (``mma.sync``, C·Bᵀ shared by a block's heads), fp32
  the CUDA-core kernel;
* on a CPU tensor it takes ``_ssd_fwd_plain``, the TPU kernel's chunk loop
  in plain PyTorch: fp32 throughout, per chunk of Q rows the cumsum of
  dt·A, the masked intra-chunk product, the read of the carried state and
  the state update.

Inputs: x (B, S, H, P) bf16 or fp32, dt (B, S, H) fp32, A (H,) fp32,
Bm/Cm (B, S, G, N) in x's dtype; head h reads group h // (H / G).
Returns y (B, S, H, P) fp32 and the final state (B, H, N, P) fp32.  The
oracle is ``models/mamba2.ssd_chunked``.  The public ``ssd`` goes through
``SSDScan``, a ``torch.autograd.Function``: the forward above, and a
backward that recomputes through ``ssd_chunked`` (y cast to fp32) and
differentiates that, as the reference's ``custom_vjp`` does
(``ssd_scan.py:115-136``); there is no backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build, dispatch

NEG = -1e30

# launches of the CUDA kernel; the wrapper adds one per launch and nothing
# else touches it except callers resetting it to 0
LAUNCHES = 0
# the same launches by the dtype of x, and the kernel design each takes
LAUNCHES_BY_DTYPE = {"bfloat16": 0, "float32": 0}
DESIGN = {"bfloat16": "mma", "float32": "cuda_cores"}

HEAD_DIMS = (8, 16, 32, 64, 128)   # P the kernel is instantiated for
MAX_STATE = 128                    # largest d_state N it takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024
# ssd_scan_fwd(x, dt, A, Bm, Cm, y, state, dtype, B, S, H, P, G, N, Q,
#              strides of x (b, s, h), dt (b, s), Bm (b, s, g), Cm (b, s, g),
#              stream)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 11 + [ctypes.c_void_p])
# ssd_scan_grid(B, S, H, P, G, N, Q, grid)
_GRID_ARGTYPES = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]


def repeat_groups(t, r: int, axis: int):
    """Group axis ``axis`` of ``t`` repeated ``r`` times per group, so
    head h reads group h // r (``jnp.repeat`` in the reference)."""
    return t if r == 1 else t.repeat_interleave(r, dim=axis)


def _ssd_fwd_plain(x, dt, A, Bm, Cm, *, chunk: int):
    """The TPU kernel's chunk loop: all batches advance together, the
    (B, H, N, P) fp32 state is carried from chunk to chunk.  ``chunk``
    must divide S."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    r = H // G
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    f32 = torch.float32
    A = A.to(f32)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    state = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xc = x[:, c0:c0 + Q].to(f32)                     # (B, Q, H, P)
        dtc = dt[:, c0:c0 + Q].to(f32)                   # (B, Q, H)
        Bc = Bm[:, c0:c0 + Q].to(f32)                    # (B, Q, G, N)
        Cc = Cm[:, c0:c0 + Q].to(f32)
        cum = torch.cumsum(dtc * A, dim=1)               # (B, Q, H)
        cum_h = cum.transpose(1, 2)                      # (B, H, Q)

        # intra-chunk: scores[h,i,j] = (C_i·B_j) exp(cum_i - cum_j) dt_j,
        # masked to j <= i before the exp
        CB = repeat_groups(torch.einsum("bigN,bjgN->bgij", Cc, Bc), r, 1)
        diff = cum_h[..., :, None] - cum_h[..., None, :]
        Lm = torch.exp(torch.where(tril, diff, NEG))
        scores = CB * Lm * dtc.transpose(1, 2)[..., None, :]
        y_intra = torch.einsum("bhij,bjhp->bihp", scores, xc)

        # inter-chunk: read the carried state
        Ch = repeat_groups(Cc, r, 2)                     # (B, Q, H, N)
        y_inter = torch.einsum("bih,bihn,bhnp->bihp", torch.exp(cum), Ch,
                               state)
        ys.append(y_intra + y_inter)

        # state update
        Bh = repeat_groups(Bc, r, 2)
        dec_end = torch.exp(cum[:, -1:] - cum)           # (B, Q, H)
        S_c = torch.einsum("bjh,bjhn,bjhp->bhnp", dec_end * dtc, Bh, xc)
        state = state * torch.exp(cum[:, -1])[..., None, None] + S_c
    return torch.cat(ys, dim=1), state


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block (csrc/ssd_scan.cu): the state,
    one row tile each of C, B and x, the score tile, cum and dt."""
    rows = 32
    return 4 * (N * P + 2 * rows * (N + 1) + rows * P + rows * (rows + 1)
                + 2 * Q)


def mma_grid(Bsz: int, S: int, H: int, P: int, G: int, N: int, Q: int):
    """(R, PS) that the bf16 kernel launches with on the current CUDA
    device: R heads of one group per block and PS columns of P per block,
    as ``ssd_scan_grid`` in csrc/ssd_scan.cu chooses them."""
    fn = cuda_build.function("ssd_scan", "ssd_scan_grid", _GRID_ARGTYPES)
    grid = (ctypes.c_int * 2)()
    err = fn(Bsz, S, H, P, G, N, Q, grid)
    if err != 0:
        raise RuntimeError(f"ssd_scan_grid failed: CUDA error {err}")
    return grid[0], grid[1]


def _cp_async_ready(t):
    """``t`` if 16-byte copies can read it (last axis contiguous, base and
    the other strides 16-byte aligned: multiples of 8 bf16), else a
    contiguous copy."""
    (s0, s1, s2, s3), (n0, n1, n2, _) = t.stride(), t.shape
    if (s3 != 1 or t.data_ptr() & 15 or (s0 & 7 and n0 > 1)
            or (s1 & 7 and n1 > 1) or (s2 & 7 and n2 > 1)):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _check_cuda_inputs(x, dt, A, Bm, Cm, Q: int):
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                             f"{name} on {t.device}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"expected x (B,S,H,P), dt (B,S,H), A (H,), "
                         f"Bm/Cm (B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.shape[:2] != (Bsz, S):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share float32 or bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if P not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim P in {HEAD_DIMS}, "
                         f"got {P}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"the CUDA kernel takes 1 <= d_state N <= "
                         f"{MAX_STATE}, got {N}")
    if G == 0 or H % G:
        raise ValueError(f"heads ({H}) must be a multiple of groups ({G})")
    if x.dtype == torch.float32 and smem_bytes(Q, N, P) > _SMEM_LIMIT:
        raise ValueError(f"chunk {Q} with N = {N}, P = {P} needs "
                         f"{smem_bytes(Q, N, P)} bytes of shared memory, "
                         f"more than a block has")


def _ssd_fwd_cuda(x, dt, A, Bm, Cm, *, chunk: int):
    """Launch ``csrc/ssd_scan.cu`` on the current stream.  Reads x, dt, Bm
    and Cm through their strides (the last axis must be contiguous, and in
    bf16 x, Bm and Cm 16-byte aligned, else that tensor is copied; Bm and
    Cm are zero-padded to a multiple of 8 states); writes new y and state
    tensors."""
    global LAUNCHES
    dispatch.refuse_fake(x, dt, A, Bm, Cm)
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    _check_cuda_inputs(x, dt, A, Bm, Cm, Q)
    if Q <= 0 or S % Q:
        raise ValueError(f"chunk {Q} must divide the sequence length {S}")
    G, N = Bm.shape[2], Bm.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        if N % 8:
            Bm, Cm = (torch.nn.functional.pad(t, (0, (-N) % 8))
                      for t in (Bm, Cm))
        x, Bm, Cm = (_cp_async_ready(t) for t in (x, Bm, Cm))
    else:
        x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (x, Bm, Cm))
    dt = dt if dt.stride(-1) == 1 else dt.contiguous()
    A = A.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    fn = cuda_build.function("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    strides = [*x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:3],
               *Cm.stride()[:3]]
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 _DTYPES[x.dtype], Bsz, S, H, P, G, N, Q, *strides,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(x.dtype)[6:]] += 1
    return y, state


def _ref(x, dt, A, Bm, Cm, chunk: int):
    """The backward's oracle, the reference's ``_ref``: ``ssd_chunked``
    with y cast to fp32 (``kernels/ref.ssd_ref``)."""
    from repro_torch.kernels.ref import ssd_ref
    return ssd_ref(x, dt, A, Bm, Cm, chunk)


class SSDScan(torch.autograd.Function):
    """Forward: the kernel on a CUDA tensor, the plain version on a CPU
    tensor.  Backward: ``_ref`` recomputed on detached copies of the saved
    inputs and differentiated by autograd, from the grads of both outputs
    (y and the final state)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        if dispatch.resolve("auto", x.device) == "cuda":
            return _ssd_fwd_cuda(x, dt, A, Bm, Cm, chunk=chunk)
        return _ssd_fwd_plain(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad[:5])]
            y, state = _ref(*ins, ctx.chunk)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad((y, state), wrt, (gy, gstate)))
        return (*(next(grads) if t.requires_grad else None for t in ins),
                None)


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """Public entry, with the reference's signature: the chunk is capped at
    S and halved until it divides S (``ssd_scan.py:139-145``), then the
    kernel runs on a CUDA tensor and the plain version on a CPU tensor.
    Returns (y (B, S, H, P) fp32, final state (B, H, N, P) fp32)."""
    Q = min(chunk, x.shape[1])
    while x.shape[1] % Q:
        Q //= 2
    return SSDScan.apply(x, dt, A, Bm, Cm, Q)
