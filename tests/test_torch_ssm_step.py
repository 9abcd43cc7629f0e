"""The fused Mamba2 decode step's route on the CPU: ``attn_impl="pallas"``
on CPU tensors runs the plain step (``models/mamba2.mamba2_step``), bit
for bit the other route's, and never reaches the kernel's wrapper, which
refuses CPU tensors; ``mixer_step``, the kernel's oracle, is the
route's step between its projections.  The kernel itself is held to the plain step on the
card (``tests/test_torch_ssm_step_cuda.py``).
"""
import pytest
import torch

from repro_torch.configs.base import ShapeSpec, Tunables
from repro_torch.kermit.serving import tiny_config
from repro_torch.kernels import ssm_step as SS
from repro_torch.models import mamba2 as M2
from repro_torch.models import model as M


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _refuse(*a, **kw):
    raise AssertionError("the kernel's wrapper was called on the CPU")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_pallas_route_on_the_cpu_runs_the_plain_step(arch, monkeypatch):
    monkeypatch.setattr(SS, "ssm_step", _refuse)
    cfg = tiny_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = M.init(gen, cfg)
    batch = M.make_batch(gen, cfg, ShapeSpec("pf", 12, 2, "prefill"))
    cache = M.init_cache(cfg, 2, 20, device="cpu")
    logits, cache = M.prefill(params, cfg, batch, Tunables(), cache=cache)
    a = cache
    b = _clone(cache)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for pos in range(12, 16):
        la, a = M.decode(params, cfg, {"tokens": tok, "pos": pos}, a,
                         Tunables(attn_impl="pallas"))
        lb, b = M.decode(params, cfg, {"tokens": tok, "pos": pos}, b,
                         Tunables())
        assert torch.equal(la, lb)
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
        tok = torch.argmax(la[:, -1], -1)[:, None].to(torch.int32)


def test_the_wrapper_refuses_cpu_tensors():
    cfg = tiny_config("mamba2-1.3b")
    p = M2.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    st = M2.mamba2_init_state(cfg, 2, torch.float32)
    zx = torch.zeros((2, p["in_proj"].shape[1]))
    args = (zx, st["conv"], st["ssm"], p["conv_w"], p["conv_b"],
            p["dt_bias"], p["A_log"], p["D_skip"], p["norm"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        SS.ssm_step(*args, eps=cfg.norm_eps)
    # the route hands the plain step's new tensors back
    x = torch.randn((2, 1, cfg.d_model))
    _, new = M2.mamba2_step(p, x, cfg, st, impl="pallas")
    assert new is not st and new["ssm"] is not st["ssm"]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_mixer_step_is_the_step_between_the_projections(arch):
    # mamba2_step is in_proj, mixer_step, out_proj: the kernel's oracle
    # takes the kernel's arguments and gives the route's values
    cfg = tiny_config(arch)
    gen = torch.Generator().manual_seed(1)
    p = M2.mamba2_init(gen, cfg, torch.float32)
    st = M2.mamba2_init_state(cfg, 3, torch.float32)
    st["ssm"].normal_(generator=gen)
    st["conv"].normal_(generator=gen)
    x = torch.randn((3, 1, cfg.d_model), generator=gen)
    out, new = M2.mamba2_step(p, x, cfg, st)
    zx = (x @ p["in_proj"])[:, 0]
    y, mine = M2.mixer_step(zx, st["conv"], st["ssm"], p["conv_w"],
                            p["conv_b"], p["dt_bias"], p["A_log"],
                            p["D_skip"], p["norm"], eps=cfg.norm_eps)
    assert y.shape == (3, cfg.ssm.expand * cfg.d_model)
    assert torch.equal(y[:, None] @ p["out_proj"], out)
    assert all(torch.equal(mine[k], new[k]) for k in ("ssm", "conv"))
