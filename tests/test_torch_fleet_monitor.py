"""The port's ``fleet_monitor_step`` against the reference's
``fleet_monitor_step_jit`` and against S scalar ``_monitor_step`` calls.

S simulator streams tick in lockstep through a ``BatchedWindowRing``; at
every tick the fleet step (a ``torch.func.vmap`` of the scalar step) gives
labels, transition flags and horizon predictions bit-equal to both, with
no classifier, with a forest only and with forest + LSTM, in a padded
bucket (the last tenant repeated) and a full one, with and without a
feature mask.  vmap's per-tenant fallback is off inside the step, and its
warning is an error here."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import ForestConfig as JFC
from repro.core.forest import RandomForest as JRF
from repro.core.lstm import PredictorConfig as JPC
from repro.core.lstm import WorkloadPredictor as JWP
from repro.core.monitor import fleet_monitor_step_jit
from repro.core.simulator import ARCHETYPES, generate, random_schedule
from repro_torch.convert import (forest_params_from_jax,
                                 predictor_params_from_jax)
from repro_torch.core import monitor as PM
from repro_torch.core.windows import BatchedWindowRing, make_windows
from repro_torch.optim.adamw import tree_map

W = 16
F = 16
TICKS = 24


@pytest.fixture(scope="module")
def models():
    """Two reference forests and two LSTMs (seeds 0, 1), so the tenants of
    a cohort hold different parameters of one shape."""
    sim = generate(random_schedule(10, min_len=6, max_len=14, seed=1),
                   window_size=W, seed=1)
    ws = sim.windows
    labels = np.where(sim.window_labels < 0, 0, sim.window_labels)
    fc = JFC(n_trees=12, depth=5, n_classes=len(ARCHETYPES), max_samples=256)
    pc = JPC(n_classes=len(ARCHETYPES), hidden=16, window=8, epochs=4,
             batch=32)
    clfs = [JRF(fc).fit(ws.mean, labels, seed=s) for s in (0, 1)]
    preds = [JWP(pc).fit(labels, seed=s) for s in (0, 1)]
    return clfs, preds


def _streams(S):
    """(S, TICKS) window means/vars from S seeded simulator streams."""
    out = []
    for s in range(S):
        sim = generate(random_schedule(8, min_len=2, max_len=5, seed=20 + s),
                       window_size=W, seed=20 + s)
        ws = make_windows(sim.samples, W)
        assert len(ws) >= TICKS
        out.append((ws.mean[:TICKS], ws.var[:TICKS]))
    return (np.stack([m for m, _ in out]), np.stack([v for _, v in out]))


def _stack_jax(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def _stack_torch(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


@pytest.mark.parametrize("S", [3, 4], ids=["padded", "full"])
@pytest.mark.parametrize("case", ["none", "forest", "forest_lstm",
                                  "forest_lstm_mask"])
def test_fleet_step_equals_reference_and_scalar_steps(models, case, S):
    clfs, preds = models
    bucket = 4
    pad = np.concatenate([np.arange(S), np.full(bucket - S, S - 1)])
    depth, pw, pcl = 0, 1, 1
    jclf = jpred = pclf = ppred = None
    per_clf = per_pred = [None] * bucket
    if case != "none":
        depth = clfs[0].fc.depth
        per_clf = [forest_params_from_jax(clfs[t % 2].params, "cpu")
                   for t in pad]
        jclf = _stack_jax([clfs[t % 2].params for t in pad])
        pclf = _stack_torch(per_clf)
    if case.startswith("forest_lstm"):
        pw, pcl = preds[0].pc.window, preds[0].pc.n_classes
        per_pred = [predictor_params_from_jax(preds[t % 2].params, "cpu")
                    for t in pad]
        jpred = _stack_jax([preds[t % 2].params for t in pad])
        ppred = _stack_torch(per_pred)
    mask_np = None
    if case.endswith("mask"):
        mask_np = np.arange(F) % 3 != 0
    jmask = None if mask_np is None else jnp.asarray(mask_np)
    pmask = None if mask_np is None else torch.as_tensor(mask_np)
    kw = dict(n=W, alpha=0.01, quorum=0.25, depth=depth, pred_window=pw,
              pred_classes=pcl)

    means, vars_ = _streams(S)
    ring = BatchedWindowRing(S, 64, F, W)
    seen_trans = seen_pred = False
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        for k in range(TICKS):
            mean, var = means[:, k], vars_[:, k]
            if ring.total:
                pm, pv = ring.last_window()
            else:
                pm = pv = np.zeros_like(mean)
            has_prev = ring.total > 0
            hist = ring.last_labels(pw - 1)
            args = [a[pad] for a in (mean, var, pm, pv, hist)]
            want = fleet_monitor_step_jit(
                jnp.asarray(args[0][:, None]), jnp.asarray(args[1][:, None]),
                jnp.asarray(args[2]), jnp.asarray(args[3]),
                np.bool_(has_prev), jnp.asarray(args[4]),
                np.int32(ring.total), jclf, jpred, jmask, **kw)
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message=".*performance drop")
                got = PM.fleet_monitor_step(
                    torch.from_numpy(args[0][:, None]),
                    torch.from_numpy(args[1][:, None]),
                    torch.from_numpy(args[2]), torch.from_numpy(args[3]),
                    has_prev, torch.from_numpy(args[4]), ring.total, pclf,
                    ppred, pmask, **kw)
            got = [g.numpy() for g in got]
            assert [g.shape for g in got] == [(bucket, 1), (bucket, 1),
                                              (bucket, 3, 1)]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))
            for t in range(bucket):
                one = PM._monitor_step(
                    torch.from_numpy(args[0][t:t + 1]),
                    torch.from_numpy(args[1][t:t + 1]),
                    torch.from_numpy(args[2][t]),
                    torch.from_numpy(args[3][t]), has_prev,
                    torch.from_numpy(args[4][t]), ring.total, per_clf[t],
                    per_pred[t], pmask, **kw)
                for g, o in zip(got, one):
                    np.testing.assert_array_equal(g[t], o.numpy())
            ring.push_tick(mean, var, got[1][:S, 0])
            seen_trans |= bool(got[0].any())
            seen_pred |= bool((got[2] >= 0).any())
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert seen_trans
    assert seen_pred == case.startswith("forest_lstm")
    if case == "none":
        assert (ring.label == -1).all()


def test_vmap_fallback_is_off_inside_the_step(monkeypatch):
    """The step runs with vmap's per-tenant fallback disabled (an op with
    no batching rule raises) and restores the setting afterwards."""
    states = []
    real = PM._monitor_step

    def spy(*a, **kw):
        states.append(torch._C._functorch._is_vmap_fallback_enabled())
        return real(*a, **kw)
    monkeypatch.setattr(PM, "_monitor_step", spy)
    before = torch._C._functorch._is_vmap_fallback_enabled()
    z = torch.zeros((2, 1, F))
    PM.fleet_monitor_step(z, z + 1, z[:, 0], z[:, 0] + 1, False,
                          torch.zeros((2, 0), dtype=torch.int32), 0, None,
                          None, None, n=W, alpha=0.01, quorum=0.25, depth=0,
                          pred_window=1, pred_classes=1)
    assert states == [False]
    assert torch._C._functorch._is_vmap_fallback_enabled() == before

