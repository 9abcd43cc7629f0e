"""The port's ε-neighbour kernel layer against the JAX reference.

On the CPU the port runs the kernel's plain version; its counts and packed
adjacency must be bit-identical to the reference's XLA twin (same
blocking, padding and bit layout).  The CUDA kernel itself is held against
the plain version on the card in ``test_torch_kernel_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import pairdist as J
from repro_torch.kernels import dispatch
from repro_torch.kernels import pairdist as P
from torch_parity import blobs

# (n, f, eps, block): the reference tests' shapes (test_analysis_fastpath),
# odd blocks, N not a multiple of 8, and N < 8
CASES = [(64, 8, 1.5, 128), (130, 4, 1.5, 128), (257, 16, 1.5, 128),
         (96, 8, 1.2, 128), (200, 16, 1.2, 128), (200, 4, 0.9, 100),
         (160, 4, 0.9, 64), (150, 8, 1.0, 128), (5, 3, 1.0, 128),
         (20, 16, 1.0, 128)]


@pytest.mark.parametrize("n,f,eps,block", CASES)
def test_plain_matches_reference_bitwise(n, f, eps, block):
    x = blobs(n, f, seed=n + f)
    c_ref, p_ref = J.neighbor_adjacency(jnp.asarray(x), eps, block=block,
                                        impl="xla")
    c, p = P.neighbor_adjacency(torch.from_numpy(x), eps, block=block)
    assert c.dtype == torch.int32 and p.dtype == torch.uint8
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))


def test_padding_rows_follow_the_reference():
    # zero-padded rows are not masked in the reference: they count the real
    # points within ε of the origin; the port reproduces that exactly
    x = np.zeros((13, 4), np.float32)
    x[:5] = 0.1
    x[5:] = 5.0
    c_ref, p_ref = J.neighbor_adjacency(jnp.asarray(x), 1.0, impl="xla")
    c, p = P.neighbor_adjacency(torch.from_numpy(x), 1.0)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    assert c.shape == (16,) and int(c[15]) == 5


@pytest.mark.parametrize("n,f", [(64, 8), (130, 4), (257, 16)])
def test_neighbor_count_matches_reference(n, f):
    x = blobs(n, f, seed=n)
    got = P.neighbor_count(torch.from_numpy(x), 1.5)
    want = J.ref_neighbor_count(jnp.asarray(x), 1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ref_oracles_match_reference():
    x = blobs(96, 8, seed=7)
    np.testing.assert_array_equal(
        P.ref_adjacency(torch.from_numpy(x), 1.2).numpy(),
        np.asarray(J.ref_adjacency(jnp.asarray(x), 1.2)))
    np.testing.assert_allclose(
        P.ref_pairdist(torch.from_numpy(x)).numpy(),
        np.asarray(J.ref_pairdist(jnp.asarray(x))), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("width", [1, 3, 16])
def test_unpack_bits_round_trips(width):
    rng = np.random.default_rng(width)
    adj = torch.as_tensor(rng.random((9, 8 * width)) < 0.4)
    packed = P._pack_bits(adj)
    assert packed.shape == (9, width) and packed.dtype == torch.uint8
    assert torch.equal(P.unpack_bits(packed), adj)
    assert torch.equal(P.unpack_bits(packed, 8 * width - 3),
                       adj[:, :8 * width - 3])
    np.testing.assert_array_equal(
        P.unpack_bits(packed).numpy(),
        np.asarray(J.unpack_bits(jnp.asarray(packed.numpy()))))


def test_dispatch_follows_the_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for impl in ("auto", "fast", "pallas", None):
        assert dispatch.resolve(impl, cpu) == "plain"
        assert dispatch.resolve(impl, cuda) == "cuda"
    for impl in ("xla", "pallas_interpret"):
        assert dispatch.resolve(impl, cpu) == "plain"
        with pytest.raises(ValueError):
            dispatch.resolve(impl, cuda)
    assert dispatch.resolve("ref", cpu) == "ref"
    for impl in ("legacy", "seed"):          # the seed path's dense kernel
        assert dispatch.resolve(impl, cpu) == "plain"
        assert dispatch.resolve(impl, cuda) == "cuda"
    with pytest.raises(ValueError):
        dispatch.resolve("nope", cpu)


def test_entry_points_default_to_cuda():
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert dispatch.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dispatch.resolve_device(None)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((16, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        P._neighbor_adjacency_cuda(x, eps_sq=1.0, block=128)
