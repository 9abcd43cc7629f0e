"""The hand-written SSD chunked-scan kernel against its plain PyTorch
version, on the card.  Marked ``cuda``: skips where there is no GPU.
Imports no JAX, so it runs on a machine with only the port installed:

    python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py

Tolerance 1e-4 absolute and relative, the reference's own bound between
its kernel and ``ssd_chunked`` in fp32.  fp32 inputs take the CUDA-core
kernel, which differs from the plain version only in the order of its
sums; bf16 inputs take the tensor-core kernel, whose products of x, B
and C are exact and whose fp32 operands enter as bf16 hi + lo (~2^-17 of
a value), held to the same bound.  Each launch is checked to take the
design its dtype names (``LAUNCHES_BY_DTYPE``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as K

pytestmark = pytest.mark.cuda

CASES = [
    # B, S, H, P, G, N, chunk
    (2, 128, 4, 16, 1, 32, 32),              # the reference's sweep
    (1, 256, 8, 32, 2, 16, 64),
    (1, 64, 2, 8, 1, 8, 16),
    (2, 48, 4, 16, 1, 16, 32),               # chunk halves to 16
    (1, 96, 4, 32, 2, 24, 48),               # Q = 48: a partial row tile
    (2, 48, 64, 64, 1, 128, 16),             # mamba2-1.3b serving shapes
    (8, 16, 64, 64, 1, 128, 16),
    (1, 512, 64, 64, 1, 128, 256),           # mamba2-1.3b, long chunks
    (2, 48, 112, 64, 1, 64, 16),             # zamba2-7b
    (1, 128, 8, 128, 4, 128, 64),            # P = 128, four groups
    # risky for the tensor-core tiling
    (1, 96, 4, 8, 2, 24, 48),                # N = 24, P = 8, Q = 48
    (2, 12, 4, 16, 1, 16, 16),               # Q = S = 12: rows padded
    (1, 20, 4, 16, 1, 32, 16),               # 20 % 16: Q halves to 4
    (2, 64, 6, 32, 2, 16, 32),               # G = 2, three heads a group
    (1, 64, 2, 16, 1, 12, 16),               # N = 12: padded to 16
    (1, 2048, 64, 64, 1, 128, 256),          # mamba2-1.3b, B = 1
    (2, 200, 4, 32, 2, 24, 256),             # Q = 200: sub-chunks 64 x 3 + 8
]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, S, H, P, G, N, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dt)
    x = t(rng.normal(size=(B, S, H, P)))
    dt = t(np.log1p(np.exp(rng.normal(size=(B, S, H)))), torch.float32)
    A = t(-np.exp(rng.normal(size=(H,)) * 0.3), torch.float32)
    Bm = t(rng.normal(size=(B, S, G, N)) * 0.3)
    Cm = t(rng.normal(size=(B, S, G, N)) * 0.3)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda_device, case, dtype):
    B, S, H, P, G, N, chunk = case
    args = _inputs(cuda_device, B, S, H, P, G, N, dtype, seed=S * H)
    before = K.LAUNCHES
    by_dtype = dict(K.LAUNCHES_BY_DTYPE)
    y, s = K.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    # the dtype alone picks the design: bf16 mma.sync, fp32 CUDA cores
    name = str(dtype)[6:]
    assert K.LAUNCHES_BY_DTYPE == {**by_dtype, name: by_dtype[name] + 1}
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    wy, ws = K._ssd_fwd_plain(*args, chunk=Q)
    assert y.dtype == s.dtype == torch.float32
    torch.testing.assert_close(y, wy, **TOL)
    torch.testing.assert_close(s, ws, **TOL)


def test_kernel_reads_strided_inputs(cuda_device):
    """x, B and C as the mixer gives them: column slices of one conv
    output, (B, S, H, P) and (B, S, G, N) views with the conv width as the
    row stride."""
    B, S, H, P, G, N = 2, 48, 8, 64, 2, 32
    rng = np.random.default_rng(5)
    xbc = torch.from_numpy(rng.normal(size=(B, S, H * P + 2 * G * N))
                           .astype(np.float32)).to(cuda_device,
                                                   torch.bfloat16)
    x, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, Bm, Cm = (x.reshape(B, S, H, P), Bm.reshape(B, S, G, N),
                 Cm.reshape(B, S, G, N))
    assert not x.is_contiguous() and not Bm.is_contiguous()
    _, dt, A, _, _ = _inputs(cuda_device, B, S, H, P, G, N, torch.float32)
    y, s = K.ssd(x, dt, A, Bm, Cm, chunk=16)
    wy, ws = K._ssd_fwd_plain(x.contiguous(), dt, A, Bm.contiguous(),
                              Cm.contiguous(), chunk=16)
    torch.testing.assert_close(y, wy, **TOL)
    torch.testing.assert_close(s, ws, **TOL)


@pytest.mark.parametrize("P,N", [(48, 16), (64, 256)])
def test_kernel_refuses_unsupported_shapes(cuda_device, P, N):
    args = _inputs(cuda_device, 1, 16, 2, P, 1, N, torch.float32)
    with pytest.raises(ValueError, match="head_dim|d_state"):
        K.ssd(*args, chunk=16)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (8, 48, 64, 64, 1, 128, 16),             # mamba2-1.3b serving
    (1, 8192, 64, 64, 1, 128, 256),          # B = 1: too few blocks at 16
    (8, 48, 112, 64, 1, 64, 16),             # zamba2-7b
    (2, 64, 6, 32, 2, 16, 32),               # three heads a group
    (1, 64, 2, 8, 1, 8, 16),                 # P = 8
])
def test_bf16_grid_fills_the_card(cuda_device, B, S, H, P, G, N, chunk):
    """The bf16 grid that the kernel chooses: the most heads of a group per
    block (up to 4), and 16 columns of P per block unless that leaves SMs
    idle."""
    R, PS = K.mma_grid(B, S, H, P, G, N, chunk)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert R == max(d for d in (1, 2, 3, 4) if (H // G) % d == 0)
    wide = min(16, P)
    assert PS == (8 if wide == 16 and B * (H // R) * (P // 16) < sms
                  else wide)
