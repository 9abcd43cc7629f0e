"""The port's monitor against the JAX reference: holding the same trained
forest and LSTM (converted params), labels, transition flags and horizon
predictions are bit-equal on one simulator stream."""
import dataclasses

import numpy as np
import pytest

from repro.core.forest import ForestConfig as JFC
from repro.core.forest import RandomForest as JRF
from repro.core.lstm import PredictorConfig as JPC
from repro.core.lstm import WorkloadPredictor as JWP
from repro.core.monitor import KermitMonitor as JMonitor
from repro.core.simulator import ARCHETYPES, generate, random_schedule
from repro_torch.convert import (forest_params_from_jax,
                                 predictor_params_from_jax)
from repro_torch.core import monitor as PM
from repro_torch.core.forest import ForestConfig, RandomForest
from repro_torch.core.lstm import PredictorConfig, WorkloadPredictor

W = 16


def _trained_reference():
    sim = generate(random_schedule(10, min_len=6, max_len=14, seed=1),
                   window_size=W, seed=1)
    ws = sim.windows
    labels = np.where(sim.window_labels < 0, 0, sim.window_labels)
    fc = JFC(n_trees=12, depth=5, n_classes=len(ARCHETYPES), max_samples=256)
    clf = JRF(fc).fit(ws.mean, labels, seed=0)
    pc = JPC(n_classes=len(ARCHETYPES), hidden=16, window=8, epochs=6,
             batch=32)
    pred = JWP(pc).fit(labels, seed=0)
    return clf, pred


def _ported(clf, pred):
    pclf = RandomForest(ForestConfig(**dataclasses.asdict(clf.fc)),
                        device="cpu")
    pclf.params = forest_params_from_jax(clf.params, "cpu")
    ppred = WorkloadPredictor(PredictorConfig(**dataclasses.asdict(pred.pc)),
                              device="cpu")
    ppred.params = predictor_params_from_jax(pred.params, "cpu")
    return pclf, ppred


def _contexts(mon, samples, chunks):
    out = []
    for lo, hi in zip(chunks[:-1], chunks[1:]):
        out += [(c.window_id, c.current_label, c.in_transition,
                 dict(c.predicted)) for c in mon.ingest_array(samples[lo:hi])]
    return out


@pytest.mark.parametrize("chunk", [8 * W + 5, 200 * W])
def test_monitor_matches_reference(chunk):
    clf, pred = _trained_reference()
    pclf, ppred = _ported(clf, pred)
    stream = generate(random_schedule(12, min_len=5, max_len=15, seed=7),
                      window_size=W, seed=7).samples
    cuts = list(range(0, len(stream), chunk)) + [len(stream)]
    ref = JMonitor(window_size=W, classifier=clf, predictor=pred)
    port = PM.KermitMonitor(window_size=W, classifier=pclf, predictor=ppred,
                            device="cpu")
    want = _contexts(ref, stream, cuts)
    got = _contexts(port, stream, cuts)
    assert got == want
    assert any(c[2] for c in got)                      # transitions seen
    assert any(c[3][1] >= 0 for c in got)              # predictions made
    np.testing.assert_array_equal(port.label_log, ref.label_log)
    assert port.stats["dispatches"] == ref.stats["dispatches"]


def test_monitor_without_models_and_per_sample_ingest(tmp_path):
    stream = generate([("dense_train", 6), ("decode_serve", 6)],
                      window_size=W, seed=2).samples
    ref = JMonitor(window_size=W, retention=8, ctx_retention=5)
    port = PM.KermitMonitor(window_size=W, retention=8, ctx_retention=5,
                            root=tmp_path, ctx_flush_every=4, device="cpu")
    for s in stream[:5 * W + 3]:
        a, b = ref.ingest(s), port.ingest(s)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.current_label, a.in_transition) == \
                (b.current_label, b.in_transition)
    got = port.ingest_array(stream[5 * W + 3:])
    want = ref.ingest_array(stream[5 * W + 3:])
    assert [c.in_transition for c in got] == [c.in_transition for c in want]
    assert len(port.contexts) == 5 and port.windows_emitted == len(stream) // W
    assert len(port.window_series()) == 8                 # bounded ring
    port.close()
    lines = (tmp_path / "tz" / "context.jsonl").read_text().splitlines()
    assert len(lines) == port.windows_emitted
