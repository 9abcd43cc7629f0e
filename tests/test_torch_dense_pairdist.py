"""The dense pairwise-distance kernel's plain version and the seed
(legacy) DBSCAN path against the JAX reference.

The plain version is held to the reference's interpret-mode Pallas kernel
on the reference's own sweep within atol 1e-5 + rtol 1e-6.  It is not
bitwise in general: inside the kernel body XLA's CPU compiler fuses the
squared norms into fused multiply-adds and picks the dot product's
order by shape, while the port keeps the streaming plain version's
operations (bitwise on the (64, 8) and bf16 (130, 4) cases, last-bit
differences at F = 16 on an x86 host).  What is gated is the
ε-threshold: it equals the streaming plain version's adjacency bit for
bit, and legacy DBSCAN labels equal the reference's legacy labels and the
port's fast labels.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pairdist as JK
from repro_torch.kernels import pairdist as PK
from torch_parity import blobs, to_jax, to_torch

J = importlib.import_module("repro.core.dbscan")
P = importlib.import_module("repro_torch.core.dbscan")

# tests/test_kernels.py's pairdist sweep (block 64), and two more tiles
SWEEP = [(64, 8, "float32", 64), (200, 16, "float32", 64),
         (130, 4, "bfloat16", 64), (257, 16, "float32", 128),
         (20, 16, "float32", 128)]


@pytest.mark.parametrize("n,f,dtype,block", SWEEP)
def test_plain_matches_reference_kernel(n, f, dtype, block):
    x = np.random.default_rng(n).normal(size=(n, f)).astype(np.float32)
    want = np.asarray(JK.pairdist(to_jax(x, dtype), block=block,
                                  interpret=True))
    got = PK._pairdist_plain(to_torch(x, dtype), block=block)
    assert got.shape == (n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert (got >= 0).all()


@pytest.mark.parametrize("n,f,dtype,block", SWEEP + [(600, 33, "float32",
                                                      100)])
def test_plain_threshold_is_the_streaming_adjacency(n, f, dtype, block):
    x = to_torch(blobs(n, f, seed=n), dtype)
    d2 = PK._pairdist_plain(x, block=block)
    for eps in (0.3, 0.35, 0.9, 2.0):
        eps_sq = PK._eps_sq(eps)
        counts, packed = PK._neighbor_adjacency_plain(x, eps_sq=eps_sq,
                                                      block=block)
        adj = PK.unpack_bits(packed[:n], n)
        assert torch.equal(d2 <= eps_sq, adj)
        assert torch.equal(adj.sum(1, dtype=torch.int32), counts[:n])


@pytest.mark.parametrize("n", [50, 130, 257])
@pytest.mark.parametrize("min_pts", [1, 4])
def test_legacy_labels_match_reference_and_fast_path(n, min_pts):
    x = blobs(n, 8, seed=n + min_pts)
    want = J.dbscan(x, eps=0.9, min_pts=min_pts, impl="legacy")
    for impl in ("legacy", "seed"):
        got = P.dbscan(x, eps=0.9, min_pts=min_pts, impl=impl, device="cpu")
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        P.dbscan(x, eps=0.9, min_pts=min_pts, device="cpu"), want)


def test_legacy_chain_and_noise_match_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, .05, (60, 4)),
                        rng.normal(5, .05, (60, 4)),
                        rng.uniform(-10, 10, (8, 4))]).astype(np.float32)
    got = P.dbscan(x, eps=0.5, min_pts=4, impl="legacy", device="cpu")
    np.testing.assert_array_equal(got,
                                  J.dbscan(x, eps=0.5, min_pts=4,
                                           impl="legacy"))
    assert (got == -1).sum() >= 3
    chain = np.zeros((200, 2), np.float32)
    chain[:, 0] = np.arange(200) * 0.9
    got = P.dbscan(chain, eps=1.0, min_pts=2, impl="legacy", device="cpu")
    np.testing.assert_array_equal(got, J.dbscan(chain, eps=1.0, min_pts=2,
                                                impl="legacy"))
    assert got.max() == 0


def test_pairwise_sq_dists_routes_like_the_reference():
    x = blobs(96, 8, seed=4)
    t = torch.from_numpy(x)
    assert torch.equal(P.pairwise_sq_dists(t, "legacy"),
                       PK._pairdist_plain(t))
    assert torch.equal(P.pairwise_sq_dists(t), PK.ref_pairdist(t))
    # off the origin fp32 cancellation scales with the norms: the legacy
    # route is held to 1e-5·(|x_i|² + |x_j|²) + 1e-6 (chip_smoke.py holds
    # the CUDA kernel to the same), the oracle to test_torch_pairdist's
    # tolerance
    want = np.asarray(J.pairwise_sq_dists(jnp.asarray(x), "legacy"))
    sq = (x.astype(np.float64) ** 2).sum(1)
    err = np.abs(P.pairwise_sq_dists(t, "legacy").numpy() - want)
    assert (err <= 1e-5 * (sq[:, None] + sq[None, :]) + 1e-6).all()
    np.testing.assert_allclose(
        P.pairwise_sq_dists(t).numpy(),
        np.asarray(J.pairwise_sq_dists(jnp.asarray(x), "auto")),
        rtol=1e-5, atol=1e-4)


def test_dense_wrapper_takes_cpu_tensors_to_the_plain_version():
    x = torch.from_numpy(blobs(40, 4, seed=2))
    assert torch.equal(PK.pairdist(x), PK._pairdist_plain(x))
    assert torch.equal(PK.pairdist(x, impl="seed", block=16),
                       PK._pairdist_plain(x, block=16))
    assert PK.pairdist(torch.zeros((0, 4))).shape == (0, 0)
    before = PK.DENSE_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        PK._pairdist_cuda(x)
    assert PK.DENSE_LAUNCHES == before
