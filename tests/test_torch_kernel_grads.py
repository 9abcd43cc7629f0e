"""The kernels' ``torch.autograd.Function``s (``FlashAttention``,
``SSDScan``) against the reference's ``jax.grad`` through its
``custom_vjp`` wrappers (Pallas in interpret mode), on the cases of
``tests/test_kernels.py``: the flash grad case (:53-70) and the fp32
sweep, the SSD grad case (:101-112) and the fp32 ``SSD_CASES``.  Inputs
and output cotangents come from numpy seeds; rtol and atol 1e-4, the
reference's own bound between its kernel and its oracle, with the atol of
a gradient taken relative to its largest entry where that is above 1: a
gradient of A sums B·S·P·N products of both signs, and its small entries
are differences of terms of up to 40, summed in another order by XLA.

On the CPU the Functions' forward is the plain version; their backward
(recompute through ``attention_xla`` / ``ssd_chunked``, autograd) is the
same code on the card, where ``tests/test_torch_grad_cuda.py`` holds it
with the kernel's forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ssd_scan import ssd as j_ssd
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels.ref import attention_ref, ssd_ref
from torch_parity import to_torch  # noqa: F401 (one torch thread)

TOL = dict(rtol=1e-4, atol=1e-4)

ATTN_CASES = [
    # B, Sq, Skv, H, K, d, causal, window, softcap
    (1, 64, 64, 2, 2, 32, True, 0, 0.0),        # test_kernels.py:53-70
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 8, 1, 32, True, 64, 50.0),
    (2, 64, 128, 4, 4, 64, False, 0, 0.0),
    (1, 96, 96, 2, 2, 128, True, 0, 30.0),
]
SSD_CASES = [
    # B, S, H, P, G, N, chunk
    (1, 64, 2, 8, 1, 8, 16),                     # test_kernels.py:101-112
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 32, 2, 16, 64),
]


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _vjp_torch(fn, inputs, cots):
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(out, leaves,
                                [torch.from_numpy(c) for c in cots])
    return [o.detach().numpy() for o in out], [g.numpy() for g in grads]


def _vjp_jax(fn, inputs, cots):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    out = out if isinstance(out, tuple) else (out,)
    grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                else jnp.asarray(cots[0]))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_function_grads_match_reference_vjp(case):
    B, Sq, Skv, H, K, d, causal, win, cap = case
    rng = np.random.default_rng(Sq + H)
    ins = [_normal(rng, B, Sq, H, d), _normal(rng, B, Skv, K, d),
           _normal(rng, B, Skv, K, d)]
    cot = [_normal(rng, B, Sq, H, d)]
    p_out, p_g = _vjp_torch(lambda q, k, v: FA.flash_attention(
        q, k, v, causal=causal, window=win or None, softcap=cap), ins, cot)
    j_out, j_g = _vjp_jax(lambda q, k, v: j_flash(
        q, k, v, causal=causal, window=win or None, softcap=cap,
        interpret=True), ins, cot)
    np.testing.assert_allclose(p_out[0], j_out[0], **TOL)
    for a, b in zip(p_g, j_g):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_function_grads_match_reference_vjp(case):
    B, S, H, P, G, N, chunk = case
    rng = np.random.default_rng(S + H)
    dt = np.log1p(np.exp(_normal(rng, B, S, H))).astype(np.float32)
    ins = [_normal(rng, B, S, H, P), dt,
           -np.exp(_normal(rng, H, scale=0.3)).astype(np.float32),
           _normal(rng, B, S, G, N, scale=0.3),
           _normal(rng, B, S, G, N, scale=0.3)]
    cots = [_normal(rng, B, S, H, P), _normal(rng, B, H, N, P)]
    p_out, p_g = _vjp_torch(lambda *a: SSD.ssd(*a, chunk=chunk), ins, cots)
    j_out, j_g = _vjp_jax(lambda *a: j_ssd(*a, chunk=chunk, interpret=True),
                          ins, cots)
    for a, b in zip(p_out + p_g, j_out + j_g):
        np.testing.assert_allclose(
            a, b, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, float(np.abs(b).max())))


def test_functions_give_grads_only_where_asked_and_keep_the_forward():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 32, 2, 32))
               for _ in range(3))
    k.requires_grad_()
    out = FA.flash_attention(q, k, v)
    assert out.grad_fn is not None and out.grad_fn.name().startswith(
        "FlashAttention")
    assert torch.equal(out.detach(), FA._flash_fwd_plain(q, k, v))
    (gk,) = torch.autograd.grad(out.sum(), (k,))
    want = torch.autograd.grad(attention_ref(q, k, v).sum(), (k,))[0]
    torch.testing.assert_close(gk, want, **TOL)
    x = torch.from_numpy(_normal(rng, 1, 32, 2, 8)).requires_grad_()
    dt = torch.ones(1, 32, 2)
    A = -torch.ones(2)
    Bm, Cm = (torch.from_numpy(_normal(rng, 1, 32, 1, 8)) for _ in range(2))
    y, s = SSD.ssd(x, dt, A, Bm, Cm, chunk=8)
    assert torch.equal(y.detach(), SSD._ssd_fwd_plain(x, dt, A, Bm, Cm,
                                                      chunk=8)[0])
    (gx,) = torch.autograd.grad(y.sum() + s.sum(), (x,))
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, chunk=8)
    torch.testing.assert_close(gx, torch.autograd.grad(yr.sum() + sr.sum(),
                                                       (x,))[0], **TOL)
