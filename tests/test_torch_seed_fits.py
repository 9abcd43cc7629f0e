"""The seed (legacy) paths of the Knowledge and training components
against the JAX reference.

WorkloadDB: the per-record legacy loop returns the batched path's labels
and the reference's legacy labels (ported from
``tests/test_knowledge_scale.py:38-78``).  Forest: the seed eager fit
(``compiled=False``) with the reference's draws injected is bit-identical
to the reference's seed fit (features, thresholds, leaf distributions).
LSTM: the seed per-batch loop's first step within rtol 1e-5 of the
reference's, and predictions equal after a fit (raw params after many
epochs are not a target: ROADMAP caveats C2/C7).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import forest as JF
from repro.core import lstm as JL
from repro.core.characterize import characterize
from repro.core.knowledge import WorkloadDB as JDB
from repro_torch.core import forest as PF
from repro_torch.core import lstm as PL
from repro_torch.core.knowledge import WorkloadDB as PDB
from torch_parity import reference_draws  # noqa: F401 (fixture)


# -- WorkloadDB ----------------------------------------------------------------


def _fill(db, rng, n_records, F=16):
    """tests/test_knowledge_scale.py's random store, record by record."""
    for i in range(n_records):
        m = rng.uniform(0.05, 1.0, F).astype(np.float32)
        s = np.maximum(0.01, 0.1 * m).astype(np.float32)
        w = (m + rng.normal(size=(40, F)) * s).astype(np.float32)
        db.insert(characterize(w), is_synthetic=(i % 5 == 4))
        if i % 3 == 0:
            db.set_config(i, {"microbatches": i % 8}, optimal=True)
    return db


def _queries(db, rng, n=20):
    """Re-observations of stored classes and never-seen workloads."""
    out = []
    for qi in range(n):
        if qi % 2 == 0:
            src = db.records[int(rng.integers(len(db.records)))]
            c = src.characterization
            w = c["mean"] + rng.normal(size=(40, 16)) * c["std"]
        else:
            w = rng.uniform(0, 1, (40, 16))
        out.append(characterize(np.asarray(w, np.float32)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_legacy_match_equals_batched_and_reference(seed):
    n = 33 + seed
    ref = _fill(JDB(impl="legacy"), np.random.default_rng(seed), n)
    port = _fill(PDB(impl="legacy", device="cpu"),
                 np.random.default_rng(seed), n)
    assert port.impl == "legacy"
    for q in _queries(ref, np.random.default_rng(100 + seed)):
        want = ref.find_match(q)
        assert port.find_match(q) == want
        assert port.find_match(q, impl="auto") == want
        legacy = port.nearest_config(q)
        assert legacy == ref.nearest_config(q)            # bit-equal distance
        fast = port.nearest_config(q, impl="fast")
        assert (fast is None) == (legacy is None)
        if fast is not None:
            assert fast[:2] == legacy[:2]
            assert fast[2] == pytest.approx(legacy[2], abs=1e-5)
        for kw in ({"exclude_label": 0}, {"tenant": 0}):
            assert port.nearest_config(q, **kw) == ref.nearest_config(q, **kw)


def test_legacy_parity_survives_inplace_mutation():
    rng = np.random.default_rng(7)
    db = _fill(PDB(device="cpu"), rng, 12)
    q0 = _queries(db, rng, 1)[0]
    db.observe(0, q0)
    db.set_config(5, {"microbatches": 7}, optimal=True)
    db.records[5].config = None          # rediscovery-style config drop
    db._update_row(db.records[5])
    for q in _queries(db, rng, 6):
        assert db.find_match(q) == db.find_match(q, impl="legacy")
        fast, legacy = db.nearest_config(q), db.nearest_config(
            q, impl="seed")
        assert (fast is None) == (legacy is None)
        if fast:
            assert fast[:2] == legacy[:2]


# -- forest --------------------------------------------------------------------


def _data(n, f, c, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    x = rng.normal(size=(n, f)).astype(np.float32) + 0.6 * y[:, None]
    x[np.arange(n), rng.integers(0, f, n)] += y
    return x.astype(np.float32), y


# (n, f, classes in the data, ForestConfig); the second has labels beyond
# the class cap, which the seed fit's one-hot rows drop.  The reference
# compiles its eager ops per shape, so the cases share every shape and
# the second reuses the first's compilations.
SEED_CASES = [(300, 16, 5, dict(n_trees=4, depth=3, n_classes=8)),
              (300, 16, 12, dict(n_trees=4, depth=3, n_classes=8))]


@pytest.mark.parametrize("case", range(len(SEED_CASES)))
def test_seed_forest_fit_matches_reference(reference_draws, case):
    n, f, c, fc = SEED_CASES[case]
    x, y = _data(n, f, c, seed=n)
    ref = JF.RandomForest(JF.ForestConfig(**fc)).fit(x, y, seed=3,
                                                     compiled=False)
    port = PF.RandomForest(PF.ForestConfig(**fc), device="cpu").fit(
        x, y, seed=3, compiled=False)
    for key, want in zip(("feat", "thr", "dist"), ref.params):
        np.testing.assert_array_equal(port.params[key].numpy(),
                                      np.asarray(want))
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))


def test_seed_forest_is_the_compiled_fit_at_full_bootstrap():
    # the seed fit weights N draws; the compiled fit gathers them — same
    # trees for in-range labels, and max_samples does not apply to it
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, 500)
    x = (rng.normal(size=(500, 8)) + 3.0 * y[:, None]).astype(np.float32)
    fc = PF.ForestConfig(n_trees=6, depth=5, n_classes=4)
    seed = PF.RandomForest(fc, device="cpu").fit(x, y, seed=2,
                                                 compiled=False)
    comp = PF.RandomForest(fc, device="cpu").fit(x, y, seed=2)
    capped = PF.RandomForest(dataclasses.replace(fc, max_samples=64),
                             device="cpu").fit(x, y, seed=2, compiled=False)
    for key in ("feat", "thr", "dist"):
        assert torch.equal(seed.params[key], comp.params[key])
        assert torch.equal(seed.params[key], capped.params[key])
    assert seed.score(x, y) >= 0.9


# -- LSTM ----------------------------------------------------------------------


def _pc(**kw):
    base = dict(n_classes=4, hidden=16, window=6, batch=32, lr=1e-2)
    base.update(kw)
    return PL.PredictorConfig(**base)


def _labels(reps=30):
    return np.array([0, 1, 2, 3, 3, 2] * reps, np.int32)


def _fits(pc, seq, seed):
    ref = JL.WorkloadPredictor(JL.PredictorConfig(
        **dataclasses.asdict(pc))).fit(seq, seed=seed, compiled=False)
    port = PL.WorkloadPredictor(pc, device="cpu").fit(seq, seed=seed,
                                                      compiled=False)
    return ref, port


def test_seed_lstm_first_step_matches_reference(reference_draws):
    # 48 labels -> 32 windows: one batch of 32, one epoch, one step
    pc = _pc(epochs=1)
    ref, port = _fits(pc, _labels(8), seed=6)
    for key in ("wx", "wh", "b"):
        np.testing.assert_allclose(port.params[key].numpy(),
                                   np.asarray(ref.params[key]),
                                   rtol=1e-5, atol=1e-6)
    for key, want in ref.params["heads"].items():
        np.testing.assert_allclose(port.params["heads"][key].numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-6)


def test_seed_lstm_fit_predicts_like_reference(reference_draws):
    pc = _pc(epochs=12)
    seq = _labels()
    ref, port = _fits(pc, seq, seed=4)
    xs, _ = PL._make_dataset(seq, pc)
    want, got = ref.predict(xs), port.predict(xs)
    for h in PL.HORIZONS:
        np.testing.assert_array_equal(got[h], want[h])
    assert all(v >= 0.9 for v in port.score(seq).values())


def test_seed_lstm_runs_every_epoch(monkeypatch):
    steps = []
    real = PL._train_step
    monkeypatch.setattr(PL, "_train_step",
                        lambda *a: steps.append(1) or real(*a))
    pc = _pc(epochs=20, early_stop_tol=0.5, patience=1, target_loss=10.0)
    seq = _labels(12)
    n_batches = (len(seq) - pc.window - 10) // pc.batch
    PL.WorkloadPredictor(pc, device="cpu").fit(seq, seed=1, compiled=False)
    assert len(steps) == pc.epochs * n_batches
    steps.clear()
    PL.WorkloadPredictor(pc, device="cpu").fit(seq, seed=1)
    assert len(steps) < pc.epochs * n_batches            # stopped early
