"""The hand-written dense pairwise-distance kernel against its plain
PyTorch version, on the card.  Marked ``cuda``: skips where there is no
GPU.  Imports no JAX, so it runs on a machine with only the port
installed:

    python -m pytest -q -m cuda tests/test_torch_pairdist_cuda.py

Tolerance |kernel − plain| <= 1e-5·(|x_i|² + |x_j|²) + 1e-6: the two
compute the norms and the dot product in different orders (the kernel's
sequential fmaf, cuBLAS's for the plain version), and fp32 cancellation
scales with the norms.  The kernel's ε-threshold must equal the
ε-neighbour kernel's packed bits exactly: the two share their arithmetic.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dbscan import dbscan
from repro_torch.kernels import pairdist as P

pytestmark = pytest.mark.cuda

# the reference's sweep (tests/test_kernels.py:14-16, block 64), then
# simulator-like shapes: F = 16 window means, odd N, F padded to 32 / 64;
# N on and off the kernel's 64-row and 128-column tiles, N ≡ 0, 1, 2, 3
# (mod 4) around the main path's 1955 (rows start 16-byte aligned or 4, 8,
# 12 bytes after), F = 1
CASES = [(64, 8, torch.float32), (200, 16, torch.float32),
         (130, 4, torch.bfloat16), (20, 16, torch.float32),
         (257, 16, torch.float32), (1001, 33, torch.float32),
         (640, 64, torch.float32), (4096, 16, torch.float32),
         (127, 16, torch.float32), (128, 16, torch.float32),
         (129, 1, torch.float32), (1952, 16, torch.float32),
         (1953, 16, torch.float32), (1954, 16, torch.float32),
         (1955, 16, torch.float32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _points(n, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32) * 0.5
    x[: n // 2] += 3.0
    return x


def _within(got, want, x):
    sq = (x.double() ** 2).sum(1)
    tol = 1e-5 * (sq[:, None] + sq[None, :]) + 1e-6
    return bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.parametrize("n,f,dtype", CASES)
def test_kernel_matches_plain(cuda_device, n, f, dtype):
    x = torch.from_numpy(_points(n, f, seed=n)).to(cuda_device, dtype)
    before = P.DENSE_LAUNCHES
    got = P._pairdist_cuda(x)
    want = P._pairdist_plain(x, block=64)
    torch.cuda.synchronize()
    assert P.DENSE_LAUNCHES == before + 1
    assert got.shape == (n, n) and got.dtype == torch.float32
    assert _within(got, want, x.float())
    assert (got >= 0).all() and torch.equal(got, got.T)


@pytest.mark.parametrize("n,f,dtype", CASES)
@pytest.mark.parametrize("eps", [0.3, 0.35, 1.0])
def test_threshold_equals_the_nbr_kernel_bits(cuda_device, n, f, dtype, eps):
    x = torch.from_numpy(_points(n, f, seed=n)).to(cuda_device, dtype)
    eps_sq = P._eps_sq(eps)
    d2 = P._pairdist_cuda(x)
    counts, packed = P._neighbor_adjacency_cuda(x.float(), eps_sq=eps_sq,
                                                block=128)
    adj = P.unpack_bits(packed[:n], n)
    assert torch.equal(d2 <= eps_sq, adj)
    assert torch.equal(adj.sum(1, dtype=torch.int32), counts[:n])


def test_card_legacy_dbscan_runs_the_kernel_and_matches(cuda_device):
    x = _points(600, 16, seed=1)
    before = (P.DENSE_LAUNCHES, P.LAUNCHES)
    legacy = dbscan(x, eps=1.0, min_pts=4, impl="legacy", device=cuda_device)
    assert (P.DENSE_LAUNCHES, P.LAUNCHES) == (before[0] + 1, before[1])
    np.testing.assert_array_equal(
        legacy, dbscan(x, eps=1.0, min_pts=4, device=cuda_device))
    np.testing.assert_array_equal(
        legacy, dbscan(x, eps=1.0, min_pts=4, impl="legacy", device="cpu"))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    with pytest.raises(ValueError, match="F <= 64"):
        P._pairdist_cuda(torch.zeros((8, 65), device=cuda_device))
    with pytest.raises(ValueError):
        P._pairdist_cuda(torch.zeros((8,), device=cuda_device))
    assert P._pairdist_cuda(torch.zeros((0, 4), device=cuda_device)).shape \
        == (0, 0)


@pytest.mark.parametrize("n", [127, 1955, 3910])
def test_threshold_equals_the_nbr_bits_at_exact_ties(cuda_device, n):
    # points on a grid of quarters: every d2 is exact and a multiple of
    # 1/16, so ε² taken from the matrix itself (its 2nd percentile) falls on
    # many pairs; the two kernels must threshold every tie the same way
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.integers(-2, 3, size=(n, 16)) / 4.0).astype(
        np.float32)).to(cuda_device)
    d2 = P._pairdist_cuda(x)
    eps_sq = float(d2.flatten().kthvalue(n * n // 50).values)
    assert int((d2 == eps_sq).sum()) >= 50
    counts, packed = P._neighbor_adjacency_cuda(x, eps_sq=eps_sq, block=128)
    adj = P.unpack_bits(packed[:n], n)
    assert torch.equal(d2 <= eps_sq, adj)
    assert torch.equal(adj.sum(1, dtype=torch.int32), counts[:n])
