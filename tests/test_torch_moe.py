"""The MoE FFN (``repro_torch.models.moe``) against the JAX package on
converted parameters: the same weights and inputs (numpy, seeded).

Tiny deepseek-moe-16b (shared experts) and arctic-480b (a parallel dense
FFN), at capacity factors that drop many tokens (0.25), the default
(1.25) and none (64): outputs and the aux loss at fp32 rtol/atol 1e-5,
routed indices equal.  With a zero router every probability ties, and
the port must pick the lower indices as ``jax.lax.top_k`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kermit.serving import tiny_config as j_tiny_config
from repro.models import moe as JMOE
from repro_torch.convert import model_params_from_jax
from repro_torch.kermit.serving import tiny_config
from repro_torch.models import moe as MOE

import torch_parity  # noqa: F401 (one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("deepseek-moe-16b", "arctic-480b")


def _moe(arch, seed=0, zero_router=False):
    jcfg = j_tiny_config(arch)
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    pp = model_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, jp, tiny_config(arch), pp


def _x(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("cf", [0.25, 1.25, 64.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    jcfg, jp, cfg, pp = _moe(arch)
    x = _x(cfg)
    jy, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    y, aux = MOE.moe_apply(pp, torch.from_numpy(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_expert_load_match_reference(arch):
    jcfg, jp, cfg, pp = _moe(arch, seed=1)
    x = _x(cfg, seed=1).reshape(-1, cfg.d_model)
    logits = x @ np.asarray(jp["router"])
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jg, ji = jax.lax.top_k(jnp.asarray(probs), cfg.moe.top_k)
    g, i = MOE.route(torch.from_numpy(probs), cfg.moe.top_k)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(g.numpy(), np.asarray(jg))
    x3 = x.reshape(2, -1, cfg.d_model)
    np.testing.assert_allclose(
        MOE.expert_load(pp, torch.from_numpy(x3), cfg).numpy(),
        np.asarray(JMOE.expert_load(jp, jnp.asarray(x3), jcfg)), **TOL)


@pytest.mark.parametrize("cf", [0.25, 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_tied_probabilities_route_to_the_lower_indices(arch, cf):
    """A zero router: every probability is 1/E.  ``jax.lax.top_k`` picks
    experts 0 .. k-1 for every token, and so must the port — another
    order of the k picks moves the cumsum positions and with them which
    tokens overflow capacity."""
    jcfg, jp, cfg, pp = _moe(arch, zero_router=True)
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    probs = torch.full((32, E), 1.0 / E)
    probs[:, E // 2] += 1e-3             # one clear winner, the rest tied
    _, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), K)
    _, i = MOE.route(probs, K)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert i[0].tolist() == [E // 2] + list(range(K - 1))
    x = _x(cfg, seed=2)
    jy, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    y, aux = MOE.moe_apply(pp, torch.from_numpy(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **TOL)


def test_capacity_keeps_the_reference_arithmetic():
    """C = max(int(cf·T·k/E), 1): at a serving decode batch of deepseek
    (T = 8, k = 6, E = 64, cf = 1.25) one slot per expert, so tokens
    past the first on an expert are dropped (zero rows) — the
    reference's own behaviour."""
    from repro_torch.configs.registry import get_config
    m = get_config("deepseek-moe-16b").moe
    assert max(int(m.capacity_factor * 8 * m.top_k / m.num_experts), 1) == 1
    rng = np.random.default_rng(3)
    T, D, F_, E, K = 8, 16, 8, 4, 2
    xt = rng.normal(size=(T, D)).astype(np.float32)
    idx = np.zeros((T, K), np.int32)
    idx[:, 1] = 1                                   # every token: experts 0, 1
    gate = np.full((T, K), 0.5, np.float32)
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((E, D, F_), (E, D, F_), (E, F_, D))]
    kw = dict(num_experts=E, cf=0.5)                # C = 2
    want = JMOE._dispatch_compute(jnp.asarray(xt), jnp.asarray(gate),
                                  jnp.asarray(idx), *map(jnp.asarray, w),
                                  **kw)
    got = MOE._dispatch_compute(torch.from_numpy(xt), torch.from_numpy(gate),
                                torch.from_numpy(idx).long(),
                                *map(torch.from_numpy, w), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[2:].any() and got[:2].abs().sum(-1).all()
