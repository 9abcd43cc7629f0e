"""The SSD chunked scan (``repro_torch.kernels.ssd_scan``) and the SSD
pieces of ``repro_torch.models.mamba2`` against the JAX package.

The port's plain version (what ``ssd`` runs on a CPU tensor) is held to
the reference's Pallas kernel in interpret mode and to its oracle
``ssd_chunked`` on the reference's three ``SSD_CASES``
(``tests/test_kernels.py:80-98``: one with G = 2, one with bf16 inputs)
and a case where S is not a multiple of the chunk, within the reference's
own bounds (1e-4 fp32, 5e-2 bf16).  Inputs are drawn with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd as j_ssd
from repro.models import mamba2 as JM2
from repro_torch.kernels import ssd_scan as K
from repro_torch.models import mamba2 as M2

SSD_CASES = [
    # B, S, H, P, G, N, chunk, dtype
    (2, 128, 4, 16, 1, 32, 32, "float32"),
    (1, 256, 8, 32, 2, 16, 64, "float32"),
    (1, 64, 2, 8, 1, 8, 16, "bfloat16"),
    (2, 48, 4, 16, 1, 16, 32, "float32"),     # 48 % 32: the chunk halves to 16
]


def _inputs(B, S, H, P, G, N, dtype, seed=0):
    """numpy fp32 inputs shaped like the reference sweep's; x, Bm, Cm are
    rounded to ``dtype`` (the same values in both packages)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    cast = [0, 3, 4]
    jx = [jnp.asarray(a).astype(dtype) if i in cast else jnp.asarray(a)
          for i, a in enumerate((x, dt, A, Bm, Cm))]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype) if i in cast else torch.float32)
        for i, a in enumerate(jx)]
    return jx, tx


def _chunk(S, chunk):
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_matches_interpret_kernel_and_oracle(case):
    B, S, H, P, G, N, chunk, dtype = case
    jx, tx = _inputs(B, S, H, P, G, N, dtype)
    yk, sk = j_ssd(*jx, chunk=chunk, interpret=True)
    yr, sr = JM2.ssd_chunked(*jx, _chunk(S, chunk))
    before = K.LAUNCHES
    y, s = K.ssd(*tx, chunk=chunk)
    assert K.LAUNCHES == before            # the CPU takes the plain version
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, S, H, P) and s.shape == (B, H, N, P)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for want_y, want_s in ((yk, sk), (yr, sr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s),
                                   rtol=tol, atol=tol)
    # against the kernel itself, fp32 arithmetic on the same bf16 values
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_reference(case):
    B, S, H, P, G, N, chunk, dtype = case
    jx, tx = _inputs(B, S, H, P, G, N, dtype, seed=1)
    Q = _chunk(S, chunk)
    yr, sr = JM2.ssd_chunked(*jx, Q)
    y, s = M2.ssd_chunked(*tx, Q)
    assert y.dtype == tx[0].dtype
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-4,
                               atol=1e-4)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(2)
    B, H, P, G, N = 3, 4, 16, 2, 8
    state = rng.normal(size=(B, H, N, P)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(B, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, G, N)) * 0.3).astype(np.float32)
    args = (state, x, dt, A, Bm, Cm)
    ws, wy = JM2.ssd_step(*map(jnp.asarray, args))
    gs, gy = M2.ssd_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-5,
                               atol=1e-5)


def test_steps_continue_the_chunked_scan():
    """Decoding token by token from the scan's final state gives what a
    longer scan gives: the kernel's state is the recurrence's state."""
    B, S, H, P, G, N = 1, 40, 4, 8, 1, 8
    _, tx = _inputs(B, S, H, P, G, N, "float32", seed=3)
    x, dt, A, Bm, Cm = tx
    y_all, s_all = K.ssd(x, dt, A, Bm, Cm, chunk=16)
    _, state = K.ssd(*(t[:, :32] for t in (x, dt)), A,
                     *(t[:, :32] for t in (Bm, Cm)), chunk=16)
    for t in range(32, S):
        state, y = M2.ssd_step(state, x[:, t], dt[:, t], A, Bm[:, t],
                               Cm[:, t])
        torch.testing.assert_close(y, y_all[:, t], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, s_all, rtol=1e-4, atol=1e-4)


SUB_CHUNK = 64   # rows of the bf16 kernel's sub-chunks (kSub, csrc/ssd_scan.cu)


def _split(t):
    """The hi + lo bf16 pair of an fp32 tensor, as fp32 values."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _emulate_mma(x, dt, A, Bm, Cm, *, chunk):
    """The bf16 tensor-core kernel's arithmetic (``ssd_fwd_mma``) in plain
    PyTorch: each chunk walked in sub-chunks of at most 64 rows, the state
    passed between them; x, B, C exact in bf16 and every product an fp32
    sum of exact bf16 products; C·Bᵀ once per group; the three fp32
    operands — the decay-weighted scores, the carried state and w·x with
    w = exp(cum_last − cum)·dt — enter their products as bf16 hi + lo,
    two products each; the carried state itself stays fp32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    r = H // G
    x, Bm, Cm = x.float(), Bm.float(), Cm.float()
    state = torch.zeros((Bsz, H, N, P))
    ys = []
    subs = [(c0 + s0, min(SUB_CHUNK, chunk - s0))
            for c0 in range(0, S, chunk)
            for s0 in range(0, chunk, SUB_CHUNK)]
    for c0, Q in subs:
        tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
        xh = x[:, c0:c0 + Q].permute(0, 2, 1, 3)            # (B, H, Q, P)
        dtc = dt[:, c0:c0 + Q].transpose(1, 2)               # (B, H, Q)
        Bc, Cc = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        cum = torch.cumsum(dtc * A[:, None], dim=-1)
        CB = K.repeat_groups(torch.einsum("bigN,bjgN->bgij", Cc, Bc), r, 1)
        diff = torch.where(tril, cum[..., :, None] - cum[..., None, :],
                           K.NEG)
        hi, lo = _split(CB * torch.exp(diff) * dtc[..., None, :])
        Ch = K.repeat_groups(Cc, r, 2).permute(0, 2, 1, 3)  # (B, H, Q, N)
        sh, sl = _split(state)
        y_inter = (Ch @ sh + Ch @ sl) * torch.exp(cum)[..., None]
        ys.append((hi @ xh + lo @ xh + y_inter).permute(0, 2, 1, 3))
        w = torch.exp(cum[..., -1:] - cum) * dtc
        wh, wl = _split(w[..., None] * xh)
        Bt = K.repeat_groups(Bc, r, 2).permute(0, 2, 3, 1)  # (B, H, N, Q)
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + Bt @ wh + Bt @ wl)
    return torch.cat(ys, dim=1), state


@pytest.mark.parametrize("case", [
    # B, S, H, P, G, N, chunk: the sweep's bf16 case, the card tests'
    # edge shapes (N = 24, P = 8, Q = 48; Q = S = 12; G = 2 with three
    # heads a group), mamba2's widths at a small head count, and chunks of
    # 256 and 200 rows (walked in sub-chunks of 64)
    (1, 64, 2, 8, 1, 8, 16),
    (1, 96, 4, 8, 2, 24, 48),
    (2, 12, 4, 16, 1, 16, 12),
    (2, 64, 6, 32, 2, 16, 32),
    (2, 48, 8, 64, 1, 128, 16),
    (1, 512, 2, 64, 1, 128, 256),
    (2, 200, 4, 32, 2, 24, 200),
])
def test_mma_rounding_fits_the_tolerance(case):
    """The tensor-core kernel's rounding (hi + lo splits of the fp32
    operands) stays inside the unchanged 1e-4 + 1e-4·|plain| on y and the
    state, against the plain version: shown on the CPU before the kernel
    runs on the card."""
    B, S, H, P, G, N, chunk = case
    _, tx = _inputs(B, S, H, P, G, N, "bfloat16", seed=S + N)
    got_y, got_s = _emulate_mma(*tx, chunk=chunk)
    want_y, want_s = K._ssd_fwd_plain(*tx, chunk=chunk)
    torch.testing.assert_close(got_y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


def test_cuda_kernel_refuses_cpu_tensors_and_the_cpu_runs_plain():
    _, tx = _inputs(1, 48, 2, 8, 1, 8, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        K._ssd_fwd_cuda(*tx, chunk=16)
    want = K._ssd_fwd_plain(*tx, chunk=16)
    got = K.ssd(*tx, chunk=32)              # 48 % 32: the chunk halves to 16
    assert all(torch.equal(a, b) for a, b in zip(got, want))
