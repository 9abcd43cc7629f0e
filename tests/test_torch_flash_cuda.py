"""The hand-written flash-attention kernel against its plain PyTorch
version, on the card.  Marked ``cuda``: skips where there is no GPU.
Imports no JAX, so it runs on a machine with only the port installed:

    python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

Tolerances: fp32 2e-5 absolute and relative (the reference's own, for
the CUDA-core kernel); bf16 outputs 2^-7 relative and 1e-3 absolute — the
tensor-core kernel's products are exact (bf16 in, fp32 sums) and its P
enters as bf16 hi + lo (~2^-17 of p), so it differs from the plain
version's fp32 by the order of the sums and the final rounding to bf16,
at most one step (2^-7 of a value).  Each launch is checked to take the
design its dtype names (``LAUNCHES_BY_DTYPE``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

pytestmark = pytest.mark.cuda

CASES = [
    # B, Sq, Skv, H, K, d, causal, window, softcap
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 8, 1, 32, True, 64, 50.0),
    (2, 64, 128, 4, 4, 64, False, 0, 0.0),
    (1, 96, 96, 2, 2, 128, True, 0, 30.0),
    (1, 160, 160, 12, 2, 128, True, 0, 0.0),     # qwen2-1.5b heads, padded
    (2, 40, 100, 4, 2, 32, False, 0, 0.0),
    (8, 48, 48, 12, 2, 128, True, 0, 0.0),       # the serving main path
    (1, 300, 300, 16, 8, 224, True, 64, 50.0),   # gemma2-9b's head width
    (8, 48, 48, 32, 32, 112, True, 0, 0.0),      # zamba2-7b's shared block
    (1, 200, 200, 4, 2, 112, True, 0, 0.0),
    (1, 200, 96, 4, 2, 32, True, 16, 0.0),       # rows 111.. see no key
    (1, 300, 200, 4, 2, 64, True, 16, 0.0),      # the same, KV padded
    # risky for the tensor-core tiling: d = 224 (four 64-column chunks,
    # zeros past d) with a window and a softcap; Sq != Skv with G = 6
    (2, 130, 130, 4, 2, 224, True, 48, 30.0),
    (2, 40, 200, 12, 2, 128, False, 0, 0.0),
    (1, 100, 180, 12, 2, 128, True, 0, 0.0),
    # paligemma-3b's heads (d = 256, G = 8): its serving prefill (256
    # patches + 48 tokens), and a window, softcap and padded tile
    (2, 304, 304, 8, 1, 256, True, 0, 0.0),
    (1, 130, 130, 8, 1, 256, True, 48, 30.0),
]
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda_device, case, dtype):
    B, Sq, Skv, H, K, d, causal, win, cap = case
    rng = np.random.default_rng(Sq * d)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((B, Sq, H, d), (B, Skv, K, d), (B, Skv, K, d)))
    before = FA.LAUNCHES
    by_dtype = dict(FA.LAUNCHES_BY_DTYPE)
    got = FA.flash_attention(q, k, v, causal=causal, window=win or None,
                             softcap=cap)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    # the dtype alone picks the design: bf16 wgmma, fp32 CUDA cores
    name = str(dtype)[6:]
    assert FA.LAUNCHES_BY_DTYPE == {**by_dtype, name: by_dtype[name] + 1}
    want = FA._flash_fwd_plain(q, k, v, causal=causal, window=win,
                               softcap=cap)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("kv_len", [0, 37, 100])
def test_kernel_kv_len_mask(cuda_device, kv_len):
    """``kv_len`` below Skv masks the tail; with a window, rows past
    kv_len + window - 1 (all rows at kv_len = 0) see no key."""
    rng = np.random.default_rng(kv_len)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device)
               for s in ((1, 150, 4, 64), (1, 100, 2, 64), (1, 100, 2, 64)))
    got = FA._flash_fwd(q, k, v, kv_len, causal=False, window=24)
    want = FA._flash_fwd_plain(q, k, v, kv_len, causal=False, window=24)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.parametrize("kv_len", [0, 37, 100])
def test_kernel_kv_len_mask_bf16(cuda_device, kv_len):
    """The tensor-core kernel under ``kv_len``: at 0 every row sees no key
    and averages v over the padded KV, as the reference."""
    rng = np.random.default_rng(kv_len + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for s in ((1, 150, 12, 128), (1, 100, 2, 128),
                         (1, 100, 2, 128)))
    got = FA._flash_fwd(q, k, v, kv_len, causal=False, window=24)
    want = FA._flash_fwd_plain(q, k, v, kv_len, causal=False, window=24)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("offset,width", [(1, 72), (0, 68)])
def test_kernel_reads_views_tma_cannot(cuda_device, offset, width):
    """bf16 views whose base (offset 1 element) or head stride (68
    elements: 136 bytes) break TMA's 16-byte rules are copied by the
    wrapper and give what the plain version gives."""
    rng = np.random.default_rng(width)
    big = torch.from_numpy(rng.normal(size=(2, 50, 20, width)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = (big[:, :48, a:b, offset:offset + 64]
               for a, b in ((0, 12), (12, 14), (16, 18)))
    assert q.data_ptr() % 16 or (q.stride(2) * 2) % 16
    got = FA.flash_attention(q, k, v)
    want = FA._flash_fwd_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_kernel_reads_strided_inputs(cuda_device):
    """(B, S, heads, d) views with padded strides, as projections give."""
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.normal(size=(2, 50, 20, 64)).astype(
        np.float32)).to(cuda_device)
    q, k, v = big[:, :48, :12], big[:, :48, 12:14], big[:, :48, 16:18]
    assert not q.is_contiguous()
    got = FA.flash_attention(q, k, v)
    want = FA._flash_fwd_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_kernel_refuses_unsupported_head_dim(cuda_device):
    q = torch.zeros((1, 8, 2, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q)
