"""The hand-written CUDA kernel against its plain PyTorch version, on the
card.  Marked ``cuda``: skips where there is no GPU.  Imports no JAX, so
it runs on a machine with only the port installed:

    python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dbscan import dbscan
from repro_torch.kernels import pairdist as P

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("n,f,eps,block", [(5, 3, 1.0, 128),
                                           (20, 16, 1.0, 128),
                                           (130, 4, 1.5, 128),
                                           (200, 4, 0.9, 100),
                                           (257, 33, 2.0, 64),
                                           (2048, 16, 1.5, 128)])
def test_kernel_matches_plain_bitwise(cuda_device, n, f, eps, block):
    x = torch.from_numpy(_points(n, f, seed=n)).to(cuda_device)
    eps_sq = P._eps_sq(eps)
    before = P.LAUNCHES
    c1, p1 = P._neighbor_adjacency_cuda(x, eps_sq=eps_sq, block=block)
    c2, p2 = P._neighbor_adjacency_plain(x, eps_sq=eps_sq, block=block)
    torch.cuda.synchronize()
    assert P.LAUNCHES == before + 1
    assert c1.shape == c2.shape and p1.shape == p2.shape
    assert torch.equal(c1, c2) and torch.equal(p1, p2)


def test_card_dbscan_runs_the_kernel_and_matches_cpu(cuda_device):
    x = _points(600, 16, seed=1)
    before = P.LAUNCHES
    on_card = dbscan(x, eps=1.0, min_pts=4, device=cuda_device)
    assert P.LAUNCHES == before + 1
    np.testing.assert_array_equal(on_card,
                                  dbscan(x, eps=1.0, min_pts=4, device="cpu"))


def test_cpu_only_strategies_are_refused_on_the_card(cuda_device):
    x = torch.zeros((16, 4), device=cuda_device)
    with pytest.raises(ValueError):
        P.neighbor_adjacency(x, 1.0, impl="xla")


def _grid_points(n, f, seed, spread=16):
    """Points on a grid of quarters (|x| <= spread / 4): every norm, dot
    product and distance is exact in fp32 in any order, so the kernel and
    the plain version (cuBLAS) must agree bit for bit, ties at ε included."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-spread, spread + 1, size=(n, f)) / 4.0).astype(
        np.float32)


def _assert_bitwise(x, eps, block=128):
    eps_sq = P._eps_sq(eps)
    before = P.LAUNCHES
    c1, p1 = P._neighbor_adjacency_cuda(x, eps_sq=eps_sq, block=block)
    c2, p2 = P._neighbor_adjacency_plain(x, eps_sq=eps_sq, block=block)
    torch.cuda.synchronize()
    assert P.LAUNCHES == before + 1
    assert c1.shape == c2.shape and p1.shape == p2.shape
    assert torch.equal(c1, c2) and torch.equal(p1, p2)
    return c1, p1


# N on and off the kernel's 128-point tiles (and 64-point steps), the main
# path's N = 3910, a triangle of 65 tiles (N = 8200), and F on and off the
# 16/32/64 instantiations
@pytest.mark.parametrize("n", [63, 64, 65, 127, 128, 129, 191, 192, 193,
                               255, 256, 257, 3910, 8200])
@pytest.mark.parametrize("f", [1, 16, 33, 64])
def test_kernel_tile_edges_bitwise(cuda_device, n, f):
    x = torch.from_numpy(_grid_points(n, f, seed=n + f)).to(cuda_device)
    eps = {1: 0.25, 16: 1.5, 33: 2.25, 64: 3.0}[f]    # ε² = k / 16: ties
    _assert_bitwise(x, eps)


# rows of Npad / 8 bytes that are odd or not a multiple of 16: byte stores
@pytest.mark.parametrize("n,block", [(24, 128), (20, 128), (200, 8),
                                     (1000, 40), (130, 100)])
def test_kernel_odd_row_widths_bitwise(cuda_device, n, block):
    x = torch.from_numpy(_grid_points(n, 16, seed=n)).to(cuda_device)
    _, packed = _assert_bitwise(x, 2.0, block=block)
    assert packed.shape[1] == (n + (-n) % P.block_rows(n, block)) // 8


def test_kernel_padding_rows_hold_points_near_the_origin(cuda_device):
    # N = 130 pads to 256: rows 130 .. 255 are zero vectors whose rows count
    # the real points within ε of the origin (caveat C8); columns >= N stay 0
    x = _grid_points(130, 16, seed=7, spread=2)
    x[::3] = 0.0
    counts, packed = _assert_bitwise(
        torch.from_numpy(x).to(cuda_device), 0.75)
    assert counts.shape == (256,)
    near = int((np.square(x).sum(1) <= 0.75 ** 2).sum())
    assert near > 0 and (counts[130:] == near).all()
    assert not P.unpack_bits(packed)[:, 130:].any()


def test_kernel_eps_zero_counts_duplicates(cuda_device):
    base = _grid_points(97, 16, seed=3)
    reps = np.random.default_rng(3).integers(1, 5, size=97)
    x = np.repeat(base, reps, axis=0)
    counts, _ = _assert_bitwise(torch.from_numpy(x).to(cuda_device), 0.0)
    _, inverse, mult = np.unique(x, axis=0, return_inverse=True,
                                 return_counts=True)
    np.testing.assert_array_equal(counts[:len(x)].cpu().numpy(),
                                  mult[inverse.ravel()])


@pytest.mark.parametrize("n", [24, 129, 3910])
def test_kernel_eps_covering_every_pair(cuda_device, n):
    x = torch.from_numpy(_points(n, 16, seed=n)).to(cuda_device)
    counts, packed = _assert_bitwise(x, 1e3)
    assert (counts == n).all()                 # padding rows too
    bits = P.unpack_bits(packed)
    assert bits[:, :n].all() and not bits[:, n:].any()
