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


def test_cuda_route_refuses_cpu_tensors_and_unsupported_shapes():
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        FA._flash_fwd_cuda(q, q, q)
    assert FA.HEAD_DIMS == (32, 64, 112, 128, 224)
