"""The gradients of the hand-written kernels' ``torch.autograd.Function``s
on the card.  Marked ``cuda``: skips where there is no GPU.  Imports no
JAX, so it runs on a machine with only the port installed:

    python -m pytest -q -m cuda tests/test_torch_grad_cuda.py

A CUDA input that requires grad must get a gradient on every input:
before the Functions, the kernels wrote their outputs through ctypes into
``torch.empty`` tensors, which had no ``grad_fn``, and every gradient
upstream of attention or the scan was silently dropped.

The Functions' backward differentiates the plain recompute
(``attention_xla``, ``ssd_chunked``), so their input grads equal autograd
through the plain version with the same output grads: to 1e-5 in fp32
(the same operations on the same inputs) and one bf16 step (2^-7
relative, 1e-3 absolute) in bf16.  The forward is the kernel, held to its
own tolerance by ``test_torch_flash_cuda.py`` / ``test_torch_ssd_cuda.py``.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SSD

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
# B, S, H, K, d, causal, window, softcap: qwen2-1.5b's training shape
# and the reference sweep's grad case (tests/test_kernels.py:53-70)
ATTN = [(8, 128, 12, 2, 128, True, 0, 0.0), (1, 64, 2, 2, 32, True, 0, 0.0),
        (1, 256, 8, 1, 32, True, 64, 50.0)]
# B, S, H, P, G, N, chunk: mamba2-1.3b's training shape (phase b) and
# the reference sweep's fp32 cases
SSD_CASES = [(4, 256, 64, 64, 1, 128, 256), (2, 128, 4, 16, 1, 32, 32),
             (1, 256, 8, 32, 2, 16, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    return torch.device("cuda")


def _grads(fn, inputs, gouts):
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    assert all(o.grad_fn is not None for o in out)
    return torch.autograd.grad(out, leaves, gouts)


def _check(got, want, dtype):
    for a, b in zip(got, want):
        assert a is not None and a.shape == b.shape
        assert bool(a.abs().sum() > 0), "a gradient is zero"
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN)
def test_flash_function_grads_equal_autograd_through_plain(case, dtype,
                                                           cuda_device):
    B, S, H, K, d, causal, win, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(S + H)
    q, k, v, go = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
                   for s in ((B, S, H, d), (B, S, K, d), (B, S, K, d),
                             (B, S, H, d)))
    launches = FA.LAUNCHES
    got = _grads(lambda a, b, c: FA.flash_attention(
        a, b, c, causal=causal, window=win, softcap=cap), (q, k, v), (go,))
    assert FA.LAUNCHES == launches + 1          # the forward is the kernel
    want = _grads(lambda a, b, c: FA._ref(a, b, c, causal, win, cap),
                  (q, k, v), (go,))
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_function_grads_equal_autograd_through_plain(case, dtype,
                                                         cuda_device):
    B, S, H, P, G, N, chunk = case
    g = torch.Generator(device=cuda_device).manual_seed(S + H)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)
    x = normal(B, S, H, P).to(dtype)
    dt = F.softplus(normal(B, S, H))
    A = -torch.exp(normal(H) * 0.3)
    Bm = (normal(B, S, G, N) * 0.3).to(dtype)
    Cm = (normal(B, S, G, N) * 0.3).to(dtype)
    gy, gs = normal(B, S, H, P), normal(B, H, N, P)
    launches = SSD.LAUNCHES
    got = _grads(lambda *a: SSD.ssd(*a, chunk=chunk), (x, dt, A, Bm, Cm),
                 (gy, gs))
    assert SSD.LAUNCHES == launches + 1
    want = _grads(lambda *a: SSD._ref(*a, chunk), (x, dt, A, Bm, Cm),
                  (gy, gs))
    _check(got, want, dtype)


def test_only_the_inputs_that_need_grad_get_one(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 64, 2, 32), generator=g, device=cuda_device)
               for _ in range(3))
    q.requires_grad_()
    out = FA.flash_attention(q, k, v)
    (gq,) = torch.autograd.grad(out.sum(), (q,))
    assert bool(gq.abs().sum() > 0) and k.grad is None and v.grad is None
