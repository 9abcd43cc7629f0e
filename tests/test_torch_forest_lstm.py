"""The port's forest and LSTM against the JAX reference.

Forest: with the reference's draws injected the fit is bit-identical
(features, thresholds, leaf distributions); inference on converted params
matches to rtol 1e-6 with identical argmax (the tree average is summed in
another order than XLA's fused reduction, a last-bit difference).
LSTM: logits and one training step on converted params / injected draws
match to rtol 1e-5, atol 1e-6 (float sums in another order).  Raw params
after many epochs are not a target (ROADMAP queue C, reference caveat 2).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import forest as JF
from repro.core import lstm as JL
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro_torch.convert import (forest_params_from_jax,
                                 predictor_params_from_jax)
from repro_torch.core import forest as PF
from repro_torch.core import lstm as PL
from repro_torch.optim.adamw import OptConfig, adamw_init
from torch_parity import (jax_lstm_init, jax_permutations,  # noqa: F401
                          reference_draws)


def _data(n, f, c, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    x = rng.normal(size=(n, f)).astype(np.float32) + 0.6 * y[:, None]
    x[np.arange(n), rng.integers(0, f, n)] += y
    return x.astype(np.float32), y


FOREST_CASES = [(400, 8, 2, dict(n_trees=8, depth=5)),
                (300, 16, 5, dict(n_trees=6, depth=6, max_samples=128)),
                (800, 16, 12, dict(n_trees=24, depth=6, max_samples=256)),
                (900, 16, 40, dict(n_trees=4, depth=6, max_samples=768)),
                (257, 4, 3, dict(n_trees=5, depth=3, n_quantiles=7))]


@functools.lru_cache(maxsize=None)
def _reference_forest(case: int):
    """The reference's fit for FOREST_CASES[case] (shared by the tests
    below: each JAX fit compiles anew for its shapes)."""
    n, f, c, kw = FOREST_CASES[case]
    x, y = _data(n, f, c, seed=n)
    fc = dict(kw, n_classes=c)
    return x, y, fc, JF.RandomForest(JF.ForestConfig(**fc)).fit(x, y, seed=3)


@pytest.mark.parametrize("case", range(len(FOREST_CASES)))
def test_forest_fit_with_reference_draws_is_identical(reference_draws, case):
    x, y, fc, ref = _reference_forest(case)
    port = PF.RandomForest(PF.ForestConfig(**fc), device="cpu").fit(
        x, y, seed=3)
    np.testing.assert_array_equal(port.grid.numpy(), np.asarray(ref.grid))
    for key, want in zip(("feat", "thr", "dist"), ref.params):
        np.testing.assert_array_equal(port.params[key].numpy(),
                                      np.asarray(want))
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))


@pytest.mark.parametrize("case", range(len(FOREST_CASES)))
def test_forest_proba_on_converted_params(case):
    x, y, fc, ref = _reference_forest(case)
    params = forest_params_from_jax(ref.params, "cpu")
    got = PF.forest_proba(params, torch.from_numpy(x), fc["depth"]).numpy()
    want = ref.predict_proba(x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("q", [3, 7, 16, 33])
def test_quantile_levels_match_jnp_linspace(q):
    np.testing.assert_array_equal(PF._quantile_levels(q),
                                  np.asarray(jnp.linspace(0.02, 0.98, q)))


def test_forest_own_draws_fit_and_classify():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 3, 600)
    x = (rng.normal(size=(600, 8)) + 3.0 * y[:, None]).astype(np.float32)
    rf = PF.RandomForest(PF.ForestConfig(n_trees=8, depth=5, n_classes=3),
                         device="cpu").fit(x, y, seed=0)
    assert rf.score(x, y) >= 0.95
    again = PF.RandomForest(rf.fc, device="cpu").fit(x, y, seed=0)
    assert torch.equal(again.params["thr"], rf.params["thr"])


def _pc(**kw):
    base = dict(n_classes=4, hidden=16, window=6, batch=32, lr=1e-2)
    base.update(kw)
    return PL.PredictorConfig(**base)


def _labels():
    return np.array([0, 1, 2, 3, 3, 2] * 30, np.int32)


def test_lstm_logits_on_converted_params():
    pc = _pc()
    ref = JL.WorkloadPredictor(JL.PredictorConfig(
        **dataclasses.asdict(pc), )).fit(_labels(), seed=2)
    params = predictor_params_from_jax(ref.params, "cpu")
    xs, _ = PL._make_dataset(_labels(), pc)
    oh = PL.one_hot(torch.as_tensor(xs, dtype=torch.long), pc.n_classes)
    got = PL._forward(params, oh)
    want = JL._predict_logits(ref.params, jax.nn.one_hot(xs, pc.n_classes))
    for h in PL.HORIZONS:
        np.testing.assert_allclose(got[h].detach().numpy(),
                                   np.asarray(want[h]), rtol=1e-5, atol=1e-6)


def test_lstm_train_step_with_reference_draws():
    pc = _pc()
    xs, ys = PL._make_dataset(_labels(), pc)
    order = next(jax_permutations(3, len(xs)))[:pc.batch].numpy()
    xb = jax.nn.one_hot(xs[order], pc.n_classes)
    yb = {h: jnp.asarray(v[order]) for h, v in ys.items()}
    joc = JOptConfig(lr=pc.lr, warmup=10, total_steps=pc.epochs * 8,
                     weight_decay=0.0, grad_clip=1.0)
    p0 = JL._init(jax.random.PRNGKey(2), JL.PredictorConfig(
        **dataclasses.asdict(pc)))
    loss, g = jax.value_and_grad(JL._loss_fn)(p0, xb, yb)
    want, _, _ = j_adamw_update(g, j_adamw_init(p0, joc), p0, joc)

    oc = OptConfig(**dataclasses.asdict(joc))
    params = jax_lstm_init(2, pc)
    got, opt, ploss = PL._train_step(
        params, adamw_init(params, oc), torch.as_tensor(np.asarray(xb)),
        {h: torch.as_tensor(np.asarray(v)).long() for h, v in yb.items()},
        oc)
    assert opt["count"] == 1
    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-5)
    for key in ("wx", "wh", "b"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6)
    for key in want["heads"]:
        np.testing.assert_allclose(got["heads"][key].numpy(),
                                   np.asarray(want["heads"][key]),
                                   rtol=1e-5, atol=1e-6)


def test_lstm_fit_with_reference_draws_predicts_like_reference(
        reference_draws):
    pc = _pc(epochs=20, early_stop_tol=1e-2, patience=2, target_loss=0.1)
    seq = _labels()
    ref = JL.WorkloadPredictor(JL.PredictorConfig(
        **dataclasses.asdict(pc))).fit(seq, seed=4)
    port = PL.WorkloadPredictor(pc, device="cpu").fit(seq, seed=4)
    xs, _ = PL._make_dataset(seq, pc)
    want, got = ref.predict(xs), port.predict(xs)
    for h in PL.HORIZONS:
        np.testing.assert_array_equal(got[h], want[h])
    assert all(v >= 0.9 for v in port.score(seq).values())


def test_forest_labels_beyond_class_cap_follow_reference(reference_draws):
    # the analyser caps n_classes at max_classes while DB labels keep
    # growing; the reference's scatters alias or drop such labels
    x, y = _data(500, 16, 12, seed=9)
    fc = dict(n_trees=6, depth=5, n_classes=8, max_samples=256)
    ref = JF.RandomForest(JF.ForestConfig(**fc)).fit(x, y, seed=5)
    port = PF.RandomForest(PF.ForestConfig(**fc), device="cpu").fit(
        x, y, seed=5)
    for key, want in zip(("feat", "thr", "dist"), ref.params):
        np.testing.assert_array_equal(port.params[key].numpy(),
                                      np.asarray(want))
