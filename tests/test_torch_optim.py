"""The optimizer (``repro_torch.optim``) against the JAX package: the cases
of ``tests/test_optim.py`` on the port, and ``adamw_update``,
``clip_by_global_norm`` and ``compress_tree`` fed the same parameters,
moments and gradients as the reference (numpy, seeded).

Tolerances: the update runs the reference's operations in its order, one
rounding each, so fp32 and bf16 values agree to rtol 1e-6 / atol 1e-7
(float noise only); int8 codes are equal, except by one where the
reference's m/s or v/s (the value rounded) lies within 1e-5 of a
half-integer, where one ulp of m picks the other neighbour.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     schedule)
from repro_torch.optim.compression import (apply_ef, compress_tree, ef_init,
                                           quantize)
from torch_parity import to_torch  # noqa: F401 (one torch thread)

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"stacked": (3, 4, 16), "matrix": (8, 16), "bias": (16,)}


def _train_quadratic(oc, steps=150, seed=0):
    """Minimize ||x - t||^2 with AdamW; returns the final distance."""
    target = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 16)).astype(np.float32))
    params = {"w": torch.zeros((8, 16))}
    opt = adamw_init(params, oc)
    for _ in range(steps):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw_update(grads, opt, params, oc)
    return float(torch.linalg.norm(params["w"] - target))


def test_adamw_converges_fp32():
    oc = OptConfig(lr=0.2, warmup=0, total_steps=100000, weight_decay=0.0)
    assert _train_quadratic(oc) < 0.5


@pytest.mark.parametrize("moments", ["int8", "bfloat16"])
def test_quantized_moments_close_to_fp32(moments):
    oc32 = OptConfig(lr=0.2, warmup=0, total_steps=100000, weight_decay=0.0)
    ocq = OptConfig(lr=0.2, warmup=0, total_steps=100000, weight_decay=0.0,
                    moments_dtype=moments)
    d32, dq = _train_quadratic(oc32), _train_quadratic(ocq)
    assert dq < 2 * d32 + 0.5, (dq, d32)


def test_grad_clip():
    clipped, gn = clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    assert float(gn) == pytest.approx(20.0)
    c2, _ = clip_by_global_norm({"a": torch.full((4,), 0.01)}, 1.0)
    np.testing.assert_allclose(c2["a"].numpy(), 0.01, rtol=1e-6)


def test_schedule_warmup_and_decay():
    oc = OptConfig(lr=1.0, warmup=10, total_steps=100)
    assert float(schedule(oc, 1)) < 0.2
    assert float(schedule(oc, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(schedule(oc, 100)) < 0.15
    for c in (0, 1, 5, 10, 57, 100, 200):
        assert float(schedule(oc, c)) == float(JA.schedule(
            JA.OptConfig(lr=1.0, warmup=10, total_steps=100),
            jnp.asarray(c)))


def test_compression_preserves_convergence():
    """SGD on a quadratic with int8 + error-feedback compression converges
    to the same optimum as without."""
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        32).astype(np.float32))
    for compressed in (False, True):
        w = torch.zeros(32)
        ef = ef_init({"w": w})
        for _ in range(200):
            g = {"w": 2 * (w - target)}
            if compressed:
                g, ef = compress_tree(g, ef)
            w = w - 0.02 * g["w"]
        err = float(torch.linalg.norm(w - target))
        assert err < 1e-2, (compressed, err)


# -- against the reference, the same inputs -----------------------------------


def _tree(rng, dtype="float32", scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _moment_pair(np_tree, oc_ref):
    """The reference's moment for ``np_tree`` (as its update would have
    stored it) and the port's copy."""
    jm = {k: (JA._quant(jnp.asarray(a)) if oc_ref.moments_dtype == "int8"
              else jnp.asarray(a).astype(oc_ref.moments_dtype))
          for k, a in np_tree.items()}
    pm = {k: (tuple(torch.tensor(np.asarray(t)) for t in m)
              if isinstance(m, tuple)
              else to_torch(np.asarray(m, np.float32), oc_ref.moments_dtype))
          for k, m in jm.items()}
    return jm, pm


def _assert_codes(got, want, ratio):
    """int8 codes equal, or one apart where the rounded value ``ratio``
    lies within 1e-5 of a half-integer."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    near_half = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) <= 1e-5
    assert diff.max(initial=0) <= 1 and np.all(near_half[diff == 1])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(moments, param_dtype):
    rng = np.random.default_rng(3)
    joc = JA.OptConfig(lr=1e-2, warmup=2, total_steps=50,
                       moments_dtype=moments)
    oc = OptConfig(lr=1e-2, warmup=2, total_steps=50, moments_dtype=moments)
    p_np = _tree(rng)
    jp = {k: jnp.asarray(a).astype(param_dtype) for k, a in p_np.items()}
    pp = {k: to_torch(a, param_dtype) for k, a in p_np.items()}
    m_np, v_np = _tree(rng, scale=0.1), {k: np.abs(a) for k, a in
                                         _tree(rng, scale=0.01).items()}
    jm, pm = _moment_pair(m_np, joc)
    jv, pv = _moment_pair(v_np, joc)
    for count in (0, 4):
        g_np = _tree(rng)
        jg = {k: jnp.asarray(a).astype(param_dtype) for k, a in g_np.items()}
        pg = {k: to_torch(a, param_dtype) for k, a in g_np.items()}
        jnp_, jopt, jlr = JA.adamw_update(
            jg, {"m": jm, "v": jv, "count": jnp.asarray(count, jnp.int32)},
            jp, joc)
        pnp_, popt, plr = adamw_update(
            pg, {"m": pm, "v": pv, "count": count}, pp, oc)
        assert popt["count"] == int(jopt["count"]) == count + 1
        assert float(plr) == float(jlr)
        for k in SHAPES:
            np.testing.assert_allclose(pnp_[k].float().numpy(),
                                       np.asarray(jnp_[k], np.float32), **TOL)
            assert pnp_[k].dtype == getattr(torch, param_dtype)
            for name, b in (("m", joc.b1), ("v", joc.b2)):
                got, want = popt[name][k], jopt[name][k]
                if moments != "int8":
                    assert got.dtype == getattr(torch, moments)
                    np.testing.assert_allclose(
                        got.float().numpy(), np.asarray(want, np.float32),
                        **TOL)
                    continue
                q, s = (np.asarray(t) for t in want)
                np.testing.assert_allclose(got[1].numpy(), s, **TOL)
                prev = {"m": jm, "v": jv}[name][k]
                g = jg[k].astype(jnp.float32)
                f = b * JA._dequant(*prev) + (1 - b) * (g if name == "m"
                                                        else g * g)
                _assert_codes(got[0].numpy(), q, np.asarray(f) / s)
    # the inputs are left as they were
    for k, a in p_np.items():
        assert torch.equal(pp[k], to_torch(a, param_dtype))


def test_stacked_leaf_updates_slice_by_slice_like_a_whole_update():
    """The per-layer-slice update of a stacked leaf equals updating each
    slice as its own parameter (the reference's ``lax.map``)."""
    rng = np.random.default_rng(5)
    oc = OptConfig(lr=1e-2, warmup=0, moments_dtype="int8")
    w = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    new, opt, _ = adamw_update({"w": g}, adamw_init({"w": w}, oc), {"w": w},
                               oc)
    for i in range(3):
        ni, oi, _ = adamw_update({"w": g[i]}, adamw_init({"w": w[i]}, oc),
                                 {"w": w[i]}, oc)
        assert torch.equal(new["w"][i], ni["w"])
        assert all(torch.equal(a[i], b) for a, b in
                   zip(opt["m"]["w"], oi["m"]["w"]))


def test_clip_and_norm_match_reference():
    rng = np.random.default_rng(7)
    g_np = _tree(rng, scale=3.0)
    for dtype in ("float32", "bfloat16"):
        jc, jn = JA.clip_by_global_norm(
            {k: jnp.asarray(a).astype(dtype) for k, a in g_np.items()}, 1.0)
        pc, pn = clip_by_global_norm(
            {k: to_torch(a, dtype) for k, a in g_np.items()}, 1.0)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
        for k in SHAPES:
            assert pc[k].dtype == getattr(torch, dtype)
            np.testing.assert_allclose(pc[k].float().numpy(),
                                       np.asarray(jc[k], np.float32),
                                       rtol=1e-5 if dtype == "float32"
                                       else 2 ** -8, atol=1e-7)


def test_compress_tree_matches_reference():
    rng = np.random.default_rng(9)
    g_np, e_np = _tree(rng), _tree(rng, scale=1e-3)
    jd, je = JC.compress_tree({k: jnp.asarray(a) for k, a in g_np.items()},
                              {k: jnp.asarray(a) for k, a in e_np.items()})
    pd, pe = compress_tree({k: torch.from_numpy(a) for k, a in g_np.items()},
                           {k: torch.from_numpy(a) for k, a in e_np.items()})
    for k in SHAPES:
        x = g_np[k] + e_np[k]
        q, s = JC.quantize(jnp.asarray(x))
        pq, ps = quantize(torch.from_numpy(x))
        assert float(ps) == float(s)
        _assert_codes(pq.numpy(), np.asarray(q), x / float(s))
        np.testing.assert_allclose(pd[k].numpy(), np.asarray(jd[k]), **TOL)
        np.testing.assert_allclose(pe[k].numpy(), np.asarray(je[k]), **TOL)
    d, ef = apply_ef(torch.zeros(4), torch.zeros(4))
    assert not d.any() and not ef.any()
