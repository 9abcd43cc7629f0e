"""The seed (per-sample) monitor path, ``KermitMonitor(fast=False)``,
against the port's fast path and the reference's seed path.

Holding the same trained forest and LSTM (the reference's, converted),
labels, transition flags and horizon predictions are bit-equal across the
three, trained, classifier-only and untrained; duck-typed models take the
fast path's per-window fallback in both packages (after
``tests/test_monitor_fastpath.py:78-105``).
"""
import dataclasses

import numpy as np
import pytest

from repro.core.forest import ForestConfig as JFC
from repro.core.forest import RandomForest as JRF
from repro.core.lstm import PredictorConfig as JPC
from repro.core.lstm import WorkloadPredictor as JWP
from repro.core.monitor import KermitMonitor as JMonitor
from repro.core.simulator import archetype_stats, generate
from repro_torch.convert import (forest_params_from_jax,
                                 predictor_params_from_jax)
from repro_torch.core.forest import ForestConfig, RandomForest
from repro_torch.core.knowledge import UNKNOWN
from repro_torch.core.lstm import PredictorConfig, WorkloadPredictor
from repro_torch.core.monitor import KermitMonitor

W = 16
NAMES = ["dense_train", "decode_serve", "moe_train"]


@pytest.fixture(scope="module")
def artifacts():
    """The reference's small trained classifier + predictor, and the same
    models converted to the port."""
    X, y = [], []
    for i, a in enumerate(NAMES):
        m, s = archetype_stats(a)
        rng = np.random.default_rng(i)
        X.append(m + rng.normal(size=(120, m.size)).astype(np.float32) * s)
        y.append(np.full(120, i))
    X = np.concatenate(X, dtype=np.float32)
    y = np.concatenate(y)
    clf = JRF(JFC(n_trees=8, depth=5, n_classes=len(NAMES))).fit(X, y)
    pred = JWP(JPC(n_classes=len(NAMES), hidden=16, window=6,
                   epochs=15)).fit(np.array([0, 1, 2] * 40))
    pclf = RandomForest(ForestConfig(**dataclasses.asdict(clf.fc)),
                        device="cpu")
    pclf.params = forest_params_from_jax(clf.params, "cpu")
    ppred = WorkloadPredictor(PredictorConfig(**dataclasses.asdict(pred.pc)),
                              device="cpu")
    ppred.params = predictor_params_from_jax(pred.params, "cpu")
    return (clf, pred), (pclf, ppred)


def _stream(seed, n=10):
    return generate([("dense_train", n), ("decode_serve", n),
                     ("dense_train", n)], window_size=W, seed=seed).samples


def _decisions(ctxs):
    return [(c.window_id, c.current_label, c.in_transition, dict(c.predicted))
            for c in ctxs]


def _per_sample(mon, samples):
    out = []
    for s in samples:
        c = mon.ingest(s)
        if c is not None:
            out.append(c)
    return out


@pytest.mark.parametrize("models", ["trained", "classifier", "untrained"])
def test_seed_monitor_matches_fast_path_and_reference(artifacts, models):
    (clf, pred), (pclf, ppred) = artifacts
    keep = {"trained": 2, "classifier": 1, "untrained": 0}[models]
    ref_models = dict(zip(("classifier", "predictor"), (clf, pred)[:keep]))
    port_models = dict(zip(("classifier", "predictor"), (pclf, ppred)[:keep]))
    samples = _stream(seed=keep)
    ref = _per_sample(JMonitor(window_size=W, fast=False, **ref_models),
                      samples)
    seed_mon = KermitMonitor(window_size=W, fast=False, device="cpu",
                             **port_models)
    got = _per_sample(seed_mon, samples)
    fast = KermitMonitor(window_size=W, device="cpu",
                         **port_models).ingest_array(samples)
    assert _decisions(got) == _decisions(ref) == _decisions(fast)
    assert any(c.in_transition for c in got)
    assert seed_mon.stats["dispatches"] == 0           # never the batched step
    if keep == 2:
        assert any(v != UNKNOWN for c in got for v in c.predicted.values())
    if keep == 0:
        assert all(c.current_label == UNKNOWN for c in got)


def test_seed_ingest_array_loops_per_sample(artifacts, tmp_path):
    _, (pclf, ppred) = artifacts
    samples = _stream(seed=4, n=6)
    a = KermitMonitor(window_size=W, fast=False, classifier=pclf,
                      predictor=ppred, device="cpu", root=tmp_path,
                      ctx_flush_every=5)
    got = a.ingest_array(samples[:5 * W + 3]) + a.ingest_array(
        samples[5 * W + 3:])
    b = KermitMonitor(window_size=W, fast=False, classifier=pclf,
                      predictor=ppred, device="cpu")
    assert _decisions(got) == _decisions(_per_sample(b, samples))
    assert a.pending_samples == len(samples) % W
    np.testing.assert_array_equal(a.label_log, b.label_log)
    a.close()
    lines = (tmp_path / "tz" / "context.jsonl").read_text().splitlines()
    assert len(lines) == a.windows_emitted == len(samples) // W


class _Threshold:
    """A duck-typed classifier: no fitted params, only ``predict`` — one
    feature against the midpoint of two archetypes' means."""

    def __init__(self):
        a, b = (archetype_stats(n)[0] for n in NAMES[:2])
        self.f = int(np.argmax(np.abs(a - b)))
        self.t = (a[self.f] + b[self.f]) / 2
        self.sign = 1.0 if b[self.f] > a[self.f] else -1.0

    def predict(self, x):
        x = np.asarray(x)[:, self.f]
        return (self.sign * (x - self.t) > 0).astype(np.int64)


def test_duck_typed_classifier_falls_back_per_window():
    samples = _stream(seed=6)
    clf = _Threshold()
    ref = JMonitor(window_size=W, classifier=clf).ingest_array(samples)
    fast = KermitMonitor(window_size=W, classifier=clf, device="cpu")
    got = fast.ingest_array(samples)
    seed = _per_sample(KermitMonitor(window_size=W, fast=False,
                                     classifier=clf, device="cpu"), samples)
    assert _decisions(got) == _decisions(ref) == _decisions(seed)
    assert fast.stats["dispatches"] == 0
    assert {c.current_label for c in got} >= {0, 1}
