"""The moe, vlm and encdec families (``repro_torch.models``) against the
JAX package on converted parameters: the same weights and inputs (numpy,
seeded).

Tiny deepseek-moe-16b (dense layer 0, shared experts), arctic-480b (a
parallel dense FFN), paligemma-3b (the patch prefix; on the pallas route
the prefix is dropped in both packages, ROADMAP C10) and
seamless-m4t-large-v2 (encoder memory, cross-attention): prefill logits
and caches and 4 decode steps at fp32 rtol/atol 1e-5; the port's own
decode against its forward (``tests/test_decode_consistency.py``);
``loss_fn``; and ``model_params_from_jax`` over every leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import Tunables as JTunables
from repro.kermit.serving import tiny_config as j_tiny_config
from repro.models import model as JM
from repro_torch.configs.base import ShapeSpec, Tunables
from repro_torch.convert import model_params_from_jax
from repro_torch.kermit.serving import tiny_config
from repro_torch.models import model as M

import torch_parity  # noqa: F401 (one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)
NORMS = ("ln1", "ln2", "lnx", "ln_f", "enc_ln_f", "q_norm", "k_norm")
CASES = [("deepseek-moe-16b", "xla"), ("deepseek-moe-16b", "pallas"),
         ("arctic-480b", "xla"), ("paligemma-3b", "xla"),
         ("paligemma-3b", "pallas"), ("seamless-m4t-large-v2", "xla")]


def _stack(arch, seed=0, **kw):
    jcfg = j_tiny_config(arch, **kw)
    params = JM.init(jax.random.PRNGKey(seed), jcfg)
    # nonzero norm scales, so every parameter moves the logits
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.normal(size=a.shape).astype(a.dtype)
        if str(path[-1].key) in NORMS else a, params)
    return (jcfg, params, tiny_config(arch, **kw),
            model_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu"))


def _batch(cfg, B, S, seed=0):
    """numpy inputs of a prefill of ``S`` positions: S - num_patches
    tokens and the patches (vlm), S/2 frames and S/2 tokens (encdec)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"tokens": rng.integers(0, cfg.vocab, (B, S - cfg.num_patches)
                                       ).astype(np.int32),
                "patches": rng.normal(size=(B, cfg.num_patches, cfg.d_model)
                                      ).astype(np.float32)}
    if cfg.family == "encdec":
        return {"tokens": rng.integers(0, cfg.vocab, (B, S // 2)
                                       ).astype(np.int32),
                "frames": rng.normal(size=(B, S // 2, cfg.d_model)
                                     ).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _grow(cache, extra):
    """The reference's cache padded by ``extra`` self-attention
    positions (names k, v, k0, v0; encdec's xk/xv keep their length)."""
    def grow(path, a):
        if str(path[-1].key) in ("k", "v", "k0", "v0"):
            pad = [(0, 0)] * a.ndim
            pad[-3] = (0, extra)
            return jnp.pad(a, pad)
        return a
    return jax.tree_util.tree_map_with_path(grow, cache)


def _port_cache(cfg, B, S, cap):
    if cfg.family == "encdec":
        return M.init_cache(cfg, B, S, self_len=S // 2 + cap - S,
                            device="cpu")
    return M.init_cache(cfg, B, cap, device="cpu")


@pytest.mark.parametrize("arch,impl", CASES)
def test_prefill_and_decode_match_reference(arch, impl):
    jcfg, jp, cfg, pp = _stack(arch)
    B, S, steps = 2, 32, 4
    batch = _batch(cfg, B, S)
    jt, pt = JTunables(attn_impl=impl), Tunables(attn_impl=impl)

    jl, jcache = JM.prefill(jp, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, jt)
    cache = _port_cache(cfg, B, S, S + steps)
    pl, cache = M.prefill(pp, cfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, pt,
                          cache=cache)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    jcache = _grow(jcache, steps)
    assert set(cache) == set(jcache)
    for name, a in jcache.items():
        assert tuple(cache[name].shape) == a.shape, name
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(a), **TOL)

    # decode positions as the engine passes them: after the whole prompt
    # (the patches included; for encdec past the decoder's S/2 tokens, so
    # every write is clamped to the last slot in both packages)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for i in range(steps):
        jl, jcache = JM.decode(jp, jcfg, {"tokens": jnp.asarray(tok),
                                          "pos": jnp.int32(S + i)}, jcache, jt)
        pl, cache = M.decode(pp, cfg, {"tokens": torch.from_numpy(tok),
                                       "pos": S + i}, cache, pt)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for name, a in jcache.items():
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "paligemma-3b",
                                  "seamless-m4t-large-v2"])
def test_decode_matches_forward(arch):
    """tests/test_decode_consistency.py on the port: prefill P tokens, then
    each of G decode steps against the forward over P + i + 1 tokens
    (capacity off for MoE, whose drops depend on the batch; positions
    after the patches for vlm; encdec through its own cache)."""
    cfg = tiny_config(arch)
    tun = Tunables(capacity_factor=64.0) if cfg.moe else Tunables()
    P, G = 32, 4
    params = M.init(torch.Generator().manual_seed(0), cfg)
    if cfg.family == "encdec":
        full = _batch(cfg, 2, 2 * (P + G))
        mem, offset = {"frames": torch.from_numpy(full["frames"])}, 0
    else:
        offset = cfg.num_patches if cfg.family == "vlm" else 0
        full = _batch(cfg, 2, P + G + offset)
        mem = {k: torch.from_numpy(v) for k, v in full.items()
               if k != "tokens"}
    tokens = torch.from_numpy(full["tokens"])

    def fwd(upto):
        return M.forward(params, cfg, {**mem, "tokens": tokens[:, :upto]},
                         tun)[0][:, -1]
    if cfg.family == "encdec":
        cache = M.init_cache(cfg, 2, 2 * (P + G), self_len=P + G,
                             device="cpu")
    else:
        cache = M.init_cache(cfg, 2, P + G + offset, device="cpu")
    logits, cache = M.prefill(params, cfg, {**mem, "tokens": tokens[:, :P]},
                              tun, cache=cache)
    torch.testing.assert_close(logits[:, 0], fwd(P), rtol=2e-4, atol=2e-4)
    for i in range(G):
        logits, cache = M.decode(params, cfg,
                                 {"tokens": tokens[:, P + i:P + i + 1],
                                  "pos": P + i + offset}, cache, tun)
        torch.testing.assert_close(logits[:, 0], fwd(P + i + 1), rtol=2e-4,
                                   atol=2e-4, msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "paligemma-3b"])
def test_loss_fn_matches_reference(arch):
    """Cross-entropy over the whole sequence (the patches included for
    vlm) and deepseek's aux loss summed over its MoE layers."""
    jcfg, jp, cfg, pp = _stack(arch, seed=1)
    B, S = 2, 24
    batch = _batch(cfg, B, S, seed=1)
    rng = np.random.default_rng(2)
    batch["targets"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch["mask"] = (rng.random((B, S)) > 0.2).astype(np.float32)
    jloss, jm = JM.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                           JTunables())
    loss, m = M.loss_fn(pp, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, Tunables())
    for got, want in ((loss, jloss), (m["ce"], jm["ce"]),
                      (m["aux"], jm["aux"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (float(m["aux"]) > 0) == (cfg.moe is not None)


# leaves named by the reference's init for each family (convert carries
# the whole tree; these are the ones no earlier family had)
LEAVES = {
    "deepseek-moe-16b": ["layer0/mlp/wi", "layers/moe/router",
                         "layers/moe/wi", "layers/moe/wg", "layers/moe/wo",
                         "layers/moe/shared/wo"],
    "arctic-480b": ["layers/moe/router", "layers/moe/dense/wi"],
    "paligemma-3b": ["patch_proj"],
    "seamless-m4t-large-v2": ["frame_proj", "enc_layers/attn/wq",
                              "enc_ln_f", "dec_layers/xattn/wk",
                              "dec_layers/lnx"],
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(LEAVES))
def test_model_params_from_jax_carries_every_leaf(arch, dtype):
    jcfg = j_tiny_config(arch, dtype=dtype)
    jp = jax.tree_util.tree_map(np.asarray,
                                JM.init(jax.random.PRNGKey(3), jcfg))
    pp = model_params_from_jax(jp, device="cpu")
    want, got = _leaves(jp), _leaves(pp)
    # the port's own init has the same tree, shapes and dtypes
    own = _leaves(M.init(torch.Generator().manual_seed(0),
                         tiny_config(arch, dtype=dtype)))
    assert set(got) == set(want) == set(own)
    assert set(LEAVES[arch]) <= set(got)
    for name, a in want.items():
        t = got[name]
        assert tuple(t.shape) == a.shape == tuple(own[name].shape), name
        assert t.dtype == own[name].dtype == getattr(torch, dtype), name
        assert np.array_equal(t.float().numpy(), a.astype(np.float32)), name


def test_input_specs_and_make_batch_of_the_new_families():
    for arch, want in (
            ("paligemma-3b", {"tokens": ((4, 40), torch.int32),
                              "patches": ((4, 8, 64), torch.float32),
                              "targets": ((4, 48), torch.int32),
                              "mask": ((4, 48), torch.float32)}),
            ("seamless-m4t-large-v2", {"frames": ((4, 24, 64), torch.float32),
                                       "tokens": ((4, 24), torch.int32),
                                       "targets": ((4, 24), torch.int32),
                                       "mask": ((4, 24), torch.float32)})):
        cfg = tiny_config(arch)
        jspecs = JM.input_specs(j_tiny_config(arch),
                                ShapeSpec("t", 48, 4, "train"))
        specs = M.input_specs(cfg, ShapeSpec("t", 48, 4, "train"))
        assert specs == want
        assert {k: s.shape for k, s in jspecs.items()} == {
            k: s for k, (s, _) in specs.items()}
        b = M.make_batch(torch.Generator().manual_seed(1), cfg,
                         ShapeSpec("p", 48, 4, "prefill"))
        assert set(b) == set(want) - {"targets", "mask"}
        for k, t in b.items():
            assert (tuple(t.shape), t.dtype) == want[k]
        emb = b.get("patches", b.get("frames"))
        assert 0.5 < float(emb.std()) < 1.5
