"""The SSM families (``repro_torch.models.mamba2``/``ssm_lm``) against the
JAX package on converted parameters: the same weights, the same tokens
(numpy, seeded).

Tiny mamba2 (pure SSD) and tiny zamba2 (SSD + a shared attention block
with per-group LoRA, 2 groups and 1 trailing layer), fp32: prefill logits,
SSM and conv states (and zamba2's keys and values), then 4 greedy decode
steps, on both ``attn_impl`` routes — the reference's pallas route in
interpret mode — within 2e-4 (the reference's decode-consistency bound),
greedy tokens equal.  ``ssm_chunk`` 16 under a 48-token prompt makes the
prefill carry its state across 3 chunks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import Tunables as JTunables
from repro.kermit.serving import tiny_config as j_tiny_config
from repro.models import model as JM
from repro_torch.configs.base import Tunables
from repro_torch.convert import model_params_from_jax
from repro_torch.kermit.serving import tiny_config
from repro_torch.models import model as M

TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's entry points, compiled once per (config, tunables)
J_INIT = jax.jit(JM.init, static_argnums=1)
J_PREFILL = jax.jit(JM.prefill, static_argnums=(1, 3))
J_DECODE = jax.jit(JM.decode, static_argnums=(1, 4))
ARCHS = ["mamba2-1.3b", "zamba2-7b"]
# parameters that start at 0 or 1 and are moved, so every one of them
# reaches the logits (zamba2's LoRA B starts at 0)
PERTURB = ("ln", "ln1", "ln2", "ln_f", "norm", "conv_b", "dt_bias",
           "D_skip", "lora_b")


@functools.lru_cache(maxsize=None)
def _stack(arch, seed=0, dtype="float32"):
    """(reference config, its params, port config, converted params).
    Tests read them and do not modify them."""
    jcfg = j_tiny_config(arch, dtype=dtype)
    params = J_INIT(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        if str(path[-1].key) in PERTURB else a, params)
    return (jcfg, params, tiny_config(arch, dtype=dtype),
            model_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu"))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _leaves(tree, prefix=""):
    """{path: array} of a nested dict (jax or torch leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, impl):
    jcfg, jp, cfg, pp = _stack(arch)
    B, S, steps = 2, 48, 4
    toks = _tokens(B, S, cfg.vocab)
    jt = JTunables(attn_impl=impl, ssm_chunk=16)
    pt = Tunables(attn_impl=impl, ssm_chunk=16)

    jl, jcache = J_PREFILL(jp, jcfg, {"tokens": jnp.asarray(toks)}, jt)
    cache = M.init_cache(cfg, B, S + steps, device="cpu")
    pl, cache = M.prefill(pp, cfg, {"tokens": torch.as_tensor(toks)}, pt,
                          cache=cache)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    want, got = _leaves(jcache), _leaves(cache)
    assert set(want) == set(got)
    for name, a in want.items():
        g = got[name]
        if name in ("/k", "/v"):            # capacity S + steps >= S
            assert not g[:, :, S:].any()
            g = g[:, :, :S]
        np.testing.assert_allclose(_np(g), _np(a), **TOL, err_msg=name)
    assert got["/ssm" if arch.startswith("mamba") else "/g_ssm/ssm"].dtype \
        == torch.float32

    jcache = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.pad(a, [(0, 0), (0, 0), (0, steps), (0, 0),
                                    (0, 0)])
        if str(path[-1].key) in ("k", "v") else a, jcache)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    assert np.array_equal(tok[:, 0], pl[:, -1].argmax(-1).numpy())
    for i in range(steps):
        jl, jcache = J_DECODE(jp, jcfg, {"tokens": jnp.asarray(tok),
                                          "pos": jnp.int32(S + i)}, jcache, jt)
        pl, cache = M.decode(pp, cfg, {"tokens": torch.as_tensor(tok),
                                       "pos": S + i}, cache, pt)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        assert np.array_equal(tok[:, 0], pl[:, -1].argmax(-1).numpy())
    want, got = _leaves(jcache), _leaves(cache)
    for name, a in want.items():
        np.testing.assert_allclose(_np(got[name]), _np(a), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill + decode reproduces the full forward's last logits (the
    reference's ``test_decode_matches_forward``, on the port alone)."""
    _, _, cfg, pp = _stack(arch)
    P, steps = 32, 4
    toks = torch.as_tensor(_tokens(2, P + steps, cfg.vocab, seed=1))
    tun = Tunables(ssm_chunk=16)

    def fwd(upto):
        return M.forward(pp, cfg, {"tokens": toks[:, :upto]}, tun)[0][:, -1]
    cache = M.init_cache(cfg, 2, P + steps, device="cpu")
    logits, cache = M.prefill(pp, cfg, {"tokens": toks[:, :P]}, tun,
                              cache=cache)
    torch.testing.assert_close(logits[:, 0], fwd(P), **TOL)
    for i in range(steps):
        logits, cache = M.decode(pp, cfg, {"tokens": toks[:, P + i:P + i + 1],
                                           "pos": P + i}, cache, tun)
        torch.testing.assert_close(logits[:, 0], fwd(P + i + 1), **TOL)


def test_bf16_pallas_route_casts_like_the_xla_route():
    """ROADMAP C12: at bfloat16 the reference's pallas route raises (the
    kernel's fp32 y turns the layer output fp32 and the layer scan refuses
    it); the port casts y to the input dtype where ``ssd_chunked`` does.
    Its pallas route then lies as close to the reference's xla route as
    bf16 rounding moves the reference itself: no farther than the
    reference's bf16 logits lie from its fp32 logits on the same
    (bf16-valued) weights."""
    jcfg, jp, cfg, pp = _stack("mamba2-1.3b", dtype="bfloat16")
    toks = _tokens(2, 48, cfg.vocab, seed=2)
    batch = {"tokens": jnp.asarray(toks)}
    jt = dict(ssm_chunk=16)
    with pytest.raises(TypeError, match="carry"):
        JM.forward(jp, jcfg, batch, JTunables(attn_impl="pallas", **jt))
    want = np.asarray(JM.forward(jp, jcfg, batch, JTunables(
        attn_impl="xla", **jt))[0], np.float32)
    exact = np.asarray(JM.forward(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp),
        jcfg.replace(dtype="float32"), batch,
        JTunables(attn_impl="xla", **jt))[0])
    rounding = np.abs(want - exact).max()
    assert 0 < rounding < 0.05 * np.abs(exact).max()
    for impl in ("pallas", "xla"):
        got = M.forward(pp, cfg, {"tokens": torch.as_tensor(toks)},
                        Tunables(attn_impl=impl, **jt))[0]
        assert got.dtype == torch.bfloat16
        assert np.abs(got.float().numpy() - want).max() <= rounding, impl


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    import json

    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "16",
                "--gen", "3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated"] == "2 sequences"
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0


def test_init_shapes_follow_the_reference():
    for arch in ARCHS:
        jcfg, jp, cfg, _ = _stack(arch)
        mine = _leaves(M.init(torch.Generator().manual_seed(0), cfg))
        want = _leaves(jp)
        assert set(mine) == set(want), arch
        for name, a in want.items():
            assert tuple(mine[name].shape) == a.shape, name
            assert str(mine[name].dtype).split(".")[-1] == str(a.dtype), name
