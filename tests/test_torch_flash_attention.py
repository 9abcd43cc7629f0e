"""The flash-attention kernel's plain version (the CPU route of
``repro_torch.kernels.flash_attention``) against the JAX package's Pallas
kernel in interpret mode and against the port's ``attention_xla``.

Inputs are made with numpy from a seed and fed to both.  Tolerances are
the reference's own (``tests/test_kernels.py``): 2e-5 in fp32, 3e-2 in
bf16 — the sums run in another order than XLA's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.layers import attention_xla
from torch_parity import to_jax, to_torch

CASES = [
    # B, Sq, Skv, H, K, d, causal, window, softcap, dtype
    # tests/test_kernels.py:27-33
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 256, 256, 8, 1, 32, True, 64, 50.0, "float32"),
    (2, 64, 128, 4, 4, 64, False, 0, 0.0, "float32"),
    (1, 96, 96, 2, 2, 128, True, 0, 30.0, "float32"),
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "bfloat16"),
    # qwen2-1.5b's heads: 128-row tiles pad both q and KV
    (1, 160, 160, 12, 2, 128, True, 0, 0.0, "float32"),
    (1, 160, 160, 12, 2, 128, True, 0, 0.0, "bfloat16"),
    # non-causal, Sq != Skv, KV padded
    (2, 40, 100, 4, 2, 32, False, 0, 0.0, "float32"),
    # paligemma-3b's heads: 8 query heads on one KV head of 256
    (1, 80, 80, 8, 1, 256, True, 0, 0.0, "float32"),
]


def _inputs(case, seed=0):
    B, Sq, Skv, H, K, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, d)).astype(np.float32),
            rng.normal(size=(B, Skv, K, d)).astype(np.float32),
            rng.normal(size=(B, Skv, K, d)).astype(np.float32))


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 3e-2


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_kernel_and_attention_xla(case):
    causal, win, cap, dtype = case[6:]
    q, k, v = _inputs(case)
    before = FA.LAUNCHES
    got = FA.flash_attention(*(to_torch(a, dtype) for a in (q, k, v)),
                             causal=causal, window=win or None, softcap=cap)
    assert FA.LAUNCHES == before                 # the CPU takes the plain route
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == q.shape
    want = j_flash(*(to_jax(a, dtype) for a in (q, k, v)), causal=causal,
                   window=win or None, softcap=cap, interpret=True)
    tol = _tol(dtype)
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    qt, kt, vt = (to_torch(a, dtype) for a in (q, k, v))
    oracle = attention_xla(qt, kt, vt, q_pos=torch.arange(q.shape[1]),
                           kv_pos=torch.arange(k.shape[1]), causal=causal,
                           window=win or None, softcap=cap,
                           q_chunk=q.shape[1])
    np.testing.assert_allclose(got, oracle.to(torch.float32).numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bq,bk", [(128, 128), (32, 64), (64, 16)])
def test_tiles_change_only_the_sum_order(bq, bk):
    case = CASES[1]                              # window 64, softcap 50
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, seed=1))
    want = FA._flash_fwd_plain(q, k, v, window=64, softcap=50.0)
    got = FA._flash_fwd_plain(q, k, v, window=64, softcap=50.0, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_tensor_window_and_positions_are_dropped_like_the_reference():
    """A tensor window reaches the kernel as 0 and q_pos/kv_pos are
    ignored, in both packages (ROADMAP C4, C10)."""
    case = CASES[1]
    q, k, v = _inputs(case, seed=2)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    full = FA.flash_attention(qt, kt, vt, softcap=50.0)
    dropped = FA.flash_attention(qt, kt, vt, window=torch.tensor(64),
                                 softcap=50.0, q_pos=torch.arange(256) + 7,
                                 kv_pos=torch.zeros(256))
    windowed = FA.flash_attention(qt, kt, vt, window=64, softcap=50.0)
    assert torch.equal(dropped, full)
    assert (windowed - full).abs().max() > 1e-2
    j_dropped = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        window=jnp.int32(64), softcap=50.0, interpret=True)
    np.testing.assert_allclose(dropped.numpy(), np.asarray(j_dropped),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, H, K, d, causal, window: rows 111.. see no key; KV not
    # padded (bk = Skv = 96)
    (1, 200, 96, 4, 2, 32, True, 16),
    # rows 215.. see no key; KV padded from 200 to 256 (bk = 128)
    (1, 300, 200, 4, 2, 64, True, 16),
])
def test_rows_that_see_no_key_average_v_like_the_reference(case):
    """A query row whose window lies past the last key sees no key: the
    reference's tiles are then all masked to -1e30, every p is 1, and the
    row is v summed over the Skv rows divided by the padded KV length."""
    B, Sq, Skv, H, K, d, causal, win = case
    q, k, v = _inputs(case, seed=3)
    got = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal, window=win)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=win, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    first_empty = Skv + win - 1
    kv_pad = Skv + (-Skv) % min(128, Skv)
    mean = np.repeat(v.sum(1) / kv_pad, H // K, axis=1)       # (B, H, d)
    empty = got.numpy()[:, first_empty:]
    np.testing.assert_allclose(empty, np.broadcast_to(mean[:, None],
                                                      empty.shape),
                               rtol=2e-5, atol=2e-5)


def _emulate_wgmma(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The bf16 tensor-core kernel's arithmetic (``flash_fwd_wgmma``) in
    plain PyTorch: 64-key tiles; s = q·k as fp32 sums of exact bf16
    products; the online softmax in fp32 with the reference's formulas;
    P enters the P·V product as two bf16 terms, hi = bf16(p) and
    lo = bf16(p − hi), each times bf16 v summed in fp32; the output
    rounded once to bf16."""
    B, Sq, H, d = q.shape
    K, Skv = k.shape[2], k.shape[1]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    q_pos = torch.arange(Sq)[:, None]
    m = torch.full((B, K, G, Sq, 1), FA.NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sq, d))
    for k0 in range(0, Skv, 64):
        kt, vt = kf[..., k0:k0 + 64, :], vf[..., k0:k0 + 64, :]
        s = (qf @ kt.transpose(-1, -2)) * d ** -0.5
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + kt.shape[-2])[None, :]
        ok = torch.ones((Sq, kt.shape[-2]), dtype=torch.bool)
        if causal:
            ok = ok & (k_pos <= q_pos)
        if window:
            ok = ok & (k_pos > q_pos - window)
        s = torch.where(ok, s, FA.NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = acc * corr + (hi @ vt + lo @ vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, d).to(torch.bfloat16)


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, H, K, d, causal, window, softcap: the sweep's shapes in
    # bf16, qwen2's serving heads (G = 6), zamba2's d = 112, gemma2's 224
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 8, 1, 32, True, 64, 50.0),
    (2, 64, 128, 4, 4, 64, False, 0, 0.0),
    (1, 96, 96, 2, 2, 128, True, 0, 30.0),
    (2, 48, 48, 12, 2, 128, True, 0, 0.0),
    (2, 48, 48, 8, 8, 112, True, 0, 0.0),
    (1, 160, 160, 4, 2, 224, True, 64, 50.0),
    (2, 80, 80, 8, 1, 256, True, 0, 0.0),
])
def test_wgmma_rounding_fits_the_bf16_tolerance(case):
    """The tensor-core kernel's rounding (P as bf16 hi + lo) stays inside
    the unchanged bf16 tolerance, 1e-3 + 2^-7·|plain|, against the plain
    version: shown here on the CPU before the kernel runs on the card.
    (P rounded once to bf16 reaches 1.5-2.3x that tolerance on six of
    these seven shapes.)"""
    B, Sq, Skv, H, K, d, causal, win, cap = case
    rng = np.random.default_rng(Sq + d)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               .to(torch.bfloat16)
               for sh in ((B, Sq, H, d), (B, Skv, K, d), (B, Skv, K, d)))
    got = _emulate_wgmma(q, k, v, causal=causal, window=win, softcap=cap)
    want = FA._flash_fwd_plain(q, k, v, causal=causal, window=win,
                               softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-3)


def test_cuda_route_refuses_cpu_tensors_and_unsupported_shapes():
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        FA._flash_fwd_cuda(q, q, q)
    assert FA.HEAD_DIMS == (32, 64, 112, 128, 224, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_matches_reference_attention_xla(dtype):
    """paligemma-3b's prefill attention (d = 256, G = 8 query heads on one
    KV head, causal; the prefix is dropped on this route) through the
    plain version, against the reference's ``attention_xla``."""
    from repro.models.layers import attention_xla as j_attention_xla
    case = (2, 72, 72, 8, 1, 256)
    q, k, v = _inputs(case, seed=4)
    got = FA.flash_attention(*(to_torch(a, dtype) for a in (q, k, v)))
    want = j_attention_xla(*(to_jax(a, dtype) for a in (q, k, v)),
                           q_pos=jnp.arange(72), kv_pos=jnp.arange(72),
                           causal=True)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
