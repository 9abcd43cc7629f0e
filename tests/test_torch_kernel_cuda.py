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
