"""The fused Mamba2 decode-step kernel (``kernels/ssm_step.py``,
``csrc/ssm_step.cu``) against the plain step of ``models/mamba2.py``, on
the card.  Marked ``cuda``: skips where there is no GPU.  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_ssm_step_cuda.py

* 64 chained steps of one mixer at mamba2-1.3b's and zamba2-7b's widths,
  and at mamba2-1.3b's with 8 groups of B and C, batches 1, 2 and 8,
  fp32 and bf16: the kernel route's output, state
  and conv rows against the plain route's.  fp32 at 1e-5 (the kernel
  rounds the state's update as the plain step does; only the order of
  the sums over N, the conv taps and the norm differs); bf16 at the
  repo's bf16 kernel tolerance (``test_torch_flash_cuda.py``: rtol 2^-7,
  atol 1e-3), since the kernel rounds to bf16 where the plain step does
  and a sum that lands beside a rounding boundary may round the other
  way.
* the decode of a tiny mamba2 writes its cache views in place on the
  kernel route, without ``_write_state``;
* a step captured in a CUDA graph and replayed equals the eager kernel,
  bit for bit;
* the wrapper refuses N or P it does not take and non-contiguous
  inputs, and the pallas route, which on the card has no other step,
  raises with it; on CPU tensors the wrapper raises and the route runs
  the plain step;
* ``ServeEngine.serve`` on tiny mamba2 and zamba2 gives the plain
  route's greedy tokens on the kernel route in fp32.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import Tunables
from repro_torch.configs.registry import get_config
from repro_torch.kermit.serving import ServeEngine, tiny_config
from repro_torch.kernels import ssm_step as SS
from repro_torch.models import mamba2 as M2
from repro_torch.models import model as M
from repro_torch.models import ssm_lm as S

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
PALLAS = Tunables(attn_impl="pallas")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the mixers the kernel is held to: (config, changes to its ssm widths)
MIXERS = {"mamba2-1.3b": ("mamba2-1.3b", {}),
          "zamba2-7b": ("zamba2-7b", {}),
          "mamba2-1.3b-g8": ("mamba2-1.3b", {"n_groups": 8})}


def _mixer(arch, dtype, seed=0, **ssm):
    """One mixer's config and parameters on the card, every parameter
    moved off its init so that each reaches the output."""
    cfg = get_config(arch).replace(dtype=str(dtype)[6:])
    if ssm:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, **ssm))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = M2.mamba2_init(gen, cfg, dtype)
    noise = torch.Generator(device="cuda").manual_seed(seed + 1)
    for k in ("conv_b", "D_skip", "dt_bias", "norm"):
        p[k] += (0.1 * torch.randn(p[k].shape, generator=noise,
                                   device="cuda")).to(p[k].dtype)
    return cfg, p


def _state(cfg, batch, dtype):
    st = M2.mamba2_init_state(cfg, batch, dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    st["ssm"].normal_(generator=gen)
    st["conv"].copy_(torch.randn(st["conv"].shape, generator=gen,
                                 device="cuda"))
    return st


def _x(cfg, batch, dtype, gen):
    return torch.randn((batch, 1, cfg.d_model), generator=gen,
                       device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("arch", list(MIXERS))
def test_kernel_matches_the_plain_step_over_64_steps(cuda_device, arch,
                                                     batch, dtype):
    name, widths = MIXERS[arch]
    cfg, p = _mixer(name, dtype, **widths)
    plain = _state(cfg, batch, dtype)
    fused = {k: v.clone() for k, v in plain.items()}
    gen = torch.Generator(device="cuda").manual_seed(11)
    before = SS.LAUNCHES
    for step in range(64):
        x = _x(cfg, batch, dtype, gen)
        want, plain = M2.mamba2_step(p, x, cfg, plain, impl="xla")
        got, same = M2.mamba2_step(p, x, cfg, fused, impl="pallas")
        assert same is fused
        torch.testing.assert_close(got, want, **TOL[dtype],
                                   msg=lambda m: f"step {step}: {m}")
    assert SS.LAUNCHES - before == 64
    torch.testing.assert_close(fused["ssm"], plain["ssm"], **TOL[dtype])
    torch.testing.assert_close(fused["conv"], plain["conv"], **TOL[dtype])


def test_decode_updates_the_cache_in_place(cuda_device, monkeypatch):
    cfg = tiny_config("mamba2-1.3b", n_layers=3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init(gen, cfg)
    cache = M.init_cache(cfg, 2, 16, device="cuda")
    cache["ssm"].normal_(generator=gen)
    plain = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    tok = torch.randint(0, cfg.vocab, (2, 1), generator=gen, device="cuda")
    want, plain = M.decode(params, cfg, {"tokens": tok, "pos": 3}, plain,
                           Tunables())

    def refuse(*a, **kw):
        raise AssertionError("_write_state ran on the kernel route")
    monkeypatch.setattr(S, "_write_state", refuse)
    before = SS.LAUNCHES
    got, out = M.decode(params, cfg, {"tokens": tok, "pos": 3}, cache,
                        PALLAS)
    assert SS.LAUNCHES - before == cfg.n_layers
    assert out is cache and {k: v.data_ptr() for k, v in cache.items()} \
        == ptrs
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    for k in ("ssm", "conv"):
        torch.testing.assert_close(cache[k], plain[k], **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_captured_step_replays_as_the_eager_kernel(cuda_device, dtype):
    cfg, p = _mixer("mamba2-1.3b", dtype)
    eager = _state(cfg, 2, dtype)
    static = {k: v.clone() for k, v in eager.items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    width = p["in_proj"].shape[1]

    def row():
        return torch.randn((2, width), generator=gen,
                           device="cuda").to(dtype)

    def step(zx, st):
        return SS.ssm_step(zx, st["conv"], st["ssm"], p["conv_w"],
                           p["conv_b"], p["dt_bias"], p["A_log"],
                           p["D_skip"], p["norm"], eps=cfg.norm_eps)
    zx = row()
    # the warm-up step capture asks for, on a side stream, on both copies
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(zx, static)
    torch.cuda.current_stream().wait_stream(side)
    step(zx, eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(zx, static)
    for _ in range(8):
        new = row()
        zx.copy_(new)
        graph.replay()
        want = step(new, eager)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert torch.equal(static["ssm"], eager["ssm"])
    assert torch.equal(static["conv"], eager["conv"])


def _args(p, st, zx):
    return (zx, st["conv"], st["ssm"], p["conv_w"], p["conv_b"],
            p["dt_bias"], p["A_log"], p["D_skip"], p["norm"])


@pytest.mark.parametrize("what", ["cpu", "d_state", "head_dim",
                                  "non_contiguous"])
def test_refusals_raise_on_the_card(cuda_device, what):
    ssm = {"d_state": {"d_state": 256}, "head_dim": {"head_dim": 8}}
    cfg, p = _mixer("mamba2-1.3b", torch.float32, **ssm.get(what, {}))
    st = _state(cfg, 2, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = _x(cfg, 2, torch.float32, gen)
    if what == "cpu":
        p = {k: v.cpu() for k, v in p.items()}
        st = {k: v.cpu() for k, v in st.items()}
        x = x.cpu()
    if what == "non_contiguous":
        wide = torch.zeros((2, cfg.ssm.d_conv - 1, 2 * st["conv"].shape[2]),
                           device="cuda")
        wide[..., ::2] = st["conv"]
        st = {"ssm": st["ssm"], "conv": wide[..., ::2]}
    zx = (x @ p["in_proj"])[:, 0]
    before = SS.LAUNCHES
    with pytest.raises(ValueError):
        SS.ssm_step(*_args(p, st, zx), eps=cfg.norm_eps)
    if what != "cpu":
        with pytest.raises(ValueError):
            M2.mamba2_step(p, x, cfg, st, impl="pallas")
        assert SS.LAUNCHES == before
        return
    # CPU tensors: the plain step's new tensors, bit for bit the xla route's
    got, new = M2.mamba2_step(p, x, cfg, st, impl="pallas")
    want, ref = M2.mamba2_step(p, x, cfg, st, impl="xla")
    assert SS.LAUNCHES == before and new is not st
    assert torch.equal(got, want) and torch.equal(new["ssm"], ref["ssm"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_serve_gives_the_plain_routes_tokens(cuda_device, arch,
                                             monkeypatch):
    cfg = tiny_config(arch)
    fused = ServeEngine(cfg, seed=0, device="cuda", initial=PALLAS)
    plain = ServeEngine(cfg, seed=0, device="cuda", initial=PALLAS)
    plain.params = fused.params
    got, want = {}, {}
    before = SS.LAUNCHES
    for batch, prompt in ((2, 16), (8, 40)):
        got[batch] = fused.serve(batch=batch, prompt_len=prompt,
                                 gen=12).generated
    assert SS.LAUNCHES > before
    # the same calls with every ssm decode step on the plain step
    step = M2.mamba2_step
    monkeypatch.setattr(M2, "mamba2_step", lambda *a, impl, **kw: step(
        *a, impl="xla", **kw))
    before = SS.LAUNCHES
    for batch, prompt in ((2, 16), (8, 40)):
        want[batch] = plain.serve(batch=batch, prompt_len=prompt,
                                  gen=12).generated
    assert SS.LAUNCHES == before
    for batch in got:
        assert np.array_equal(got[batch], want[batch]), batch
