"""The port's DBSCAN against the JAX reference: labels bit-identical on
the reference tests' cases (noise, a long chain, min_pts sweep,
single-link, odd block sizes, the dense oracle)."""
import importlib

import numpy as np
import pytest
import torch

from torch_parity import blobs

# the packages' __init__ re-export the function ``dbscan`` under the module
# name, so the modules are imported by path
J = importlib.import_module("repro.core.dbscan")
P = importlib.import_module("repro_torch.core.dbscan")


@pytest.mark.parametrize("n", [50, 130, 512])
@pytest.mark.parametrize("min_pts", [1, 4, 8])
def test_labels_match_reference(n, min_pts):
    x = blobs(n, 8, seed=n + min_pts)
    want = J.dbscan(x, eps=0.9, min_pts=min_pts)
    got = P.dbscan(x, eps=0.9, min_pts=min_pts, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_labels_with_noise_match_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, .05, (60, 4)),
                        rng.normal(5, .05, (60, 4)),
                        rng.uniform(-10, 10, (8, 4))]).astype(np.float32)
    got = P.dbscan(x, eps=0.5, min_pts=4, device="cpu")
    np.testing.assert_array_equal(got, J.dbscan(x, eps=0.5, min_pts=4))
    assert (got == -1).sum() >= 3


def test_chain_matches_reference():
    # worst case for one-hop propagation: a chain with diameter N
    n = 600
    x = np.zeros((n, 2), np.float32)
    x[:, 0] = np.arange(n) * 0.9
    got = P.dbscan(x, eps=1.0, min_pts=2, device="cpu")
    np.testing.assert_array_equal(got, J.dbscan(x, eps=1.0, min_pts=2))
    assert got.max() == 0


@pytest.mark.parametrize("block", [100, 64])
def test_odd_block_matches_reference(block):
    x = blobs(200, 4, seed=9)
    got = P.dbscan(x, eps=0.9, min_pts=4, block=block, device="cpu")
    np.testing.assert_array_equal(
        got, J.dbscan(x, eps=0.9, min_pts=4, block=block))


def test_single_link_matches_reference():
    x = blobs(300, 4, seed=11)
    np.testing.assert_array_equal(
        P.agglomerative_single_link(x, 0.5, device="cpu"),
        J.agglomerative_single_link(x, 0.5))


def test_dense_oracle_matches_reference_oracle_and_fast_path():
    x = blobs(257, 8, seed=3)
    ref = P.dbscan(x, eps=0.9, min_pts=4, impl="ref", device="cpu")
    np.testing.assert_array_equal(
        ref, J.dbscan(x, eps=0.9, min_pts=4, impl="ref"))
    np.testing.assert_array_equal(
        ref, P.dbscan(x, eps=0.9, min_pts=4, device="cpu"))


def test_tensor_input_keeps_its_device_and_empty_input():
    x = torch.from_numpy(blobs(64, 4, seed=1))
    np.testing.assert_array_equal(P.dbscan(x, 0.9, 4),
                                  J.dbscan(x.numpy(), 0.9, 4))
    assert P.dbscan(np.zeros((0, 4), np.float32), 0.9, device="cpu").size == 0
    with pytest.raises(NotImplementedError):
        P.dbscan(x, 0.9, 4, impl="legacy")
