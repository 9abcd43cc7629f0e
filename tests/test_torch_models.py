"""The model stack (``repro_torch.models``) against the JAX package on
converted parameters: the same weights, the same tokens (numpy, seeded).

Tiny configs of three dense families — qwen2 with GQA, qwen3 (qk-norm)
and gemma2 (softcaps, alternating window, embedding scale) — through
prefill logits and caches and 4 decode steps, on both ``attn_impl``
routes, at fp32 rtol/atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import Tunables as JTunables
from repro.kermit.serving import tiny_config as j_tiny_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.base import Tunables
from repro_torch.convert import model_params_from_jax
from repro_torch.kermit.serving import tiny_config
from repro_torch.models import layers as L
from repro_torch.models import model as M

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = [("qwen2-1.5b", dict(n_heads=4, n_kv_heads=2)),
         ("qwen3-14b", {}),
         ("gemma2-9b", {})]


def _stack(arch, kw, seed=0):
    jcfg = j_tiny_config(arch, **kw)
    params = JM.init(jax.random.PRNGKey(seed), jcfg)
    # nonzero norm scales and biases, so every parameter moves the logits
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.normal(size=a.shape).astype(a.dtype)
        if str(path[-1].key) in ("ln1", "ln2", "ln_f", "bq", "bk", "bv",
                                 "q_norm", "k_norm") else a, params)
    return (jcfg, params, tiny_config(arch, **kw),
            model_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu"))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch,kw", ARCHS)
def test_prefill_and_decode_match_reference(arch, kw, impl):
    jcfg, jp, cfg, pp = _stack(arch, kw)
    B, S, steps = 2, 24, 4
    cap = S + steps
    toks = _tokens(B, S, cfg.vocab)
    jt, pt = JTunables(attn_impl=impl), Tunables(attn_impl=impl)

    jl, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jt)
    cache = M.init_cache(cfg, B, cap, device="cpu")
    pl, cache = M.prefill(pp, cfg, {"tokens": torch.as_tensor(toks)}, pt,
                          cache=cache)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, :, :S].numpy(),
                                   np.asarray(jcache[name]), **TOL)
        assert not cache[name][:, :, S:].any()
    jcache = {n: jnp.pad(a, ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
              for n, a in jcache.items()}

    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for i in range(steps):
        jl, jcache = JM.decode(jp, jcfg, {"tokens": jnp.asarray(tok),
                                          "pos": jnp.int32(S + i)}, jcache, jt)
        pl, cache = M.decode(pp, cfg, {"tokens": torch.as_tensor(tok),
                                       "pos": S + i}, cache, pt)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_gemma2_pallas_route_drops_the_window_like_the_reference():
    """ROADMAP C10: on the pallas route the per-layer window reaches the
    kernel as 0 (a tensor window is dropped), so at S = 160 > window 64
    gemma2's pallas logits differ from its xla logits — in both packages,
    and the port equals the reference on each route."""
    jcfg, jp, cfg, pp = _stack("gemma2-9b", {})
    toks = _tokens(1, 160, cfg.vocab, seed=1)
    got = {}
    for impl in ("xla", "pallas"):
        jl, _, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              JTunables(attn_impl=impl))
        pl, _, _ = M.forward(pp, cfg, {"tokens": torch.as_tensor(toks)},
                             Tunables(attn_impl=impl))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        got[impl] = pl.numpy()
    assert np.abs(got["pallas"] - got["xla"]).max() > 1e-2


def test_chunked_attention_xla_matches_reference():
    """q chunks smaller than Sq, a tensor window, kv_len and softcap."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 64, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 80, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 80, 2, 32)).astype(np.float32)
    kw = dict(causal=True, softcap=20.0, kv_len=70, q_chunk=16)
    want = JL.attention_xla(*map(jnp.asarray, (q, k, v)),
                            q_pos=jnp.arange(64) + 10, kv_pos=jnp.arange(80),
                            window=jnp.int32(24), **kw)
    got = L.attention_xla(*map(torch.from_numpy, (q, k, v)),
                          q_pos=torch.arange(64) + 10, kv_pos=torch.arange(80),
                          window=torch.tensor(24, dtype=torch.int32), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(AssertionError):
        L.attention_xla(*map(torch.from_numpy, (q, k, v)),
                        q_pos=torch.arange(64), kv_pos=torch.arange(80),
                        q_chunk=24)


def test_norm_and_rope_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    pos = np.arange(7) + 100
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), **TOL)


def test_make_batch_and_init_shapes():
    from repro_torch.configs.base import ShapeSpec
    cfg = tiny_config("qwen2-1.5b")
    gen = torch.Generator().manual_seed(0)
    params = M.init(gen, cfg)
    assert params["embed"].shape == (cfg.vocab_padded, cfg.d_model)
    assert params["layers"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
    assert params["layers"]["attn"]["bq"].shape == (
        cfg.n_layers, cfg.n_heads * cfg.hd)
    b = M.make_batch(torch.Generator().manual_seed(3), cfg,
                     ShapeSpec("pf", 16, 4, "prefill"))
    b2 = M.make_batch(torch.Generator().manual_seed(3), cfg,
                      ShapeSpec("pf", 16, 4, "prefill"))
    assert b["tokens"].shape == (4, 16) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"], b2["tokens"])
    assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < cfg.vocab
