"""The model-guided Plan of the port (``core/costmodel.py`` and
``KermitPlugin(model_guided=True)``) against the reference.

Significance analysis is host Python and equal outright.  The MLP fits in
PyTorch's summation order, not XLA's: with the reference's initial
parameters injected, its predictions after 300 full-batch Adam epochs agree
with the reference's within ``PRED_RTOL`` (measured on the CPU: at most
3.1e-7 relative over the 5184-point grid), and the model search commits
the same winner at the same cost with the same evaluation counts.  States
cross between the packages; ``model_guided=False`` is bit-identical to the
unmodelled Plan.
"""
import json

import numpy as np
import pytest
import torch

from oracles import exhaustive_oracle, seeded_objective
from repro.configs.base import DEFAULT_TUNABLES as J_DEFAULT
from repro.core import costmodel as JCM
from repro.core.explorer import Explorer as JExplorer
from repro.core.knowledge import WorkloadDB as JWorkloadDB
from repro.core.monitor import WorkloadContext as JContext
from repro.core.plugin import KermitPlugin as JPlugin
from repro_torch import convert
from repro_torch.configs.base import DEFAULT_TUNABLES
from repro_torch.core import costmodel as PCM
from repro_torch.core.explorer import DEFAULT_SPACE, Explorer
from repro_torch.core.knowledge import WorkloadDB
from repro_torch.core.monitor import WorkloadContext
from repro_torch.core.plugin import KermitPlugin

PRED_RTOL = 1e-5

SMALL_SPACE = {
    "remat": ["dots", "none", "full"],
    "microbatches": [1, 2, 4, 8],
    "attn_q_chunk": [512, 1024, 2048],
    "seq_parallel": [False, True],
    "capacity_factor": [1.0, 1.25, 1.5, 2.0],
}


def _reference_init(seed, sizes):
    """The reference's ``_init_params`` as the port's [(W, b)] tensors."""
    return [(torch.tensor(np.asarray(W)), torch.tensor(np.asarray(b)))
            for W, b in JCM._init_params(seed, sizes)]


@pytest.fixture
def reference_init(monkeypatch):
    monkeypatch.setattr(PCM, "_init_draws", _reference_init)


def _rows(pkg, objective, space, seed, n=300):
    """What WorkloadDB banks for a class: a coordinate hill-climb's trace
    plus a seeded random grid sample (``tests/test_plan_model.py``)."""
    E, start = (JExplorer, J_DEFAULT) if pkg == "ref" else \
        (Explorer, DEFAULT_TUNABLES)
    ex = E(space)
    rows = list(ex.global_search(objective).trace)
    rng = np.random.default_rng(seed)
    for i in rng.choice(ex.grid_size(), size=min(n, ex.grid_size()),
                        replace=False):
        t = ex._decode_index(start, int(i))
        rows.append((t.as_dict(), float(objective(t))))
    return rows


def _char(mean, F=8):
    return {"mean": np.full(F, mean, np.float32),
            "std": np.ones(F, np.float32), "n": 64}


def _scenario(pkg, seed, trace_rows=300, adversarial=False, **plugin_kw):
    """``benchmarks/bench_costmodel.py``'s shape: a tuned donor class with
    its banked trace and a fresh far-away target class."""
    fn = seeded_objective(seed, DEFAULT_SPACE)
    if pkg == "ref":
        db, E, P, C = JWorkloadDB(drift_eps=0.5), JExplorer, JPlugin, JContext
    else:
        db = WorkloadDB(drift_eps=0.5, device="cpu")
        E, P, C = Explorer, KermitPlugin, WorkloadContext
    donor = db.insert(_char(1.0))
    db.set_config(donor, E(DEFAULT_SPACE).global_search(fn).best.as_dict(),
                  optimal=True)
    if trace_rows:
        rows = _rows(pkg, fn, DEFAULT_SPACE, seed, n=trace_rows)
        if adversarial:
            rows = [(cfg, -cost) for cfg, cost in rows]
        db.record_trace(donor, rows)
    target = db.insert(_char(5.0))
    plug = P(db, None, E(DEFAULT_SPACE), **plugin_kw)
    ctx = C(window_id=0, timestamp=0.0, current_label=target, predicted={},
            in_transition=False)
    return plug, ctx, fn, db


def test_sensitivity_and_significant_knobs_equal_reference():
    fn = seeded_objective(4, SMALL_SPACE)
    rows = _rows("port", fn, SMALL_SPACE, 4, n=120)
    assert rows == _rows("ref", fn, SMALL_SPACE, 4, n=120)
    sens = PCM.knob_sensitivity(rows, SMALL_SPACE)
    assert sens == JCM.knob_sensitivity(rows, SMALL_SPACE)
    assert set(sens) == set(SMALL_SPACE)
    for threshold in (0.0, 0.1, 0.3, 0.6, 1.0):
        assert PCM.significant_knobs(sens, SMALL_SPACE, threshold) == \
            JCM.significant_knobs(sens, SMALL_SPACE, threshold)
    # a knob seen at one value is unknown, and kept
    one = [(dict(c, remat="dots"), v) for c, v in rows]
    assert "remat" not in PCM.knob_sensitivity(one, SMALL_SPACE)


def _grid_predictions(model, pkg):
    E, start = (JExplorer, J_DEFAULT) if pkg == "ref" else \
        (Explorer, DEFAULT_TUNABLES)
    return np.concatenate([model.predict_arrays(soa) for _, soa in
                           E(model.space)._grid_chunks(start)])


@pytest.mark.parametrize("seed", [0, 6])
def test_fit_predictions_within_rtol_of_reference(reference_init, seed):
    fn = seeded_objective(seed, SMALL_SPACE)
    rows = _rows("port", fn, SMALL_SPACE, seed, n=60)
    ref = JCM.CostModel(SMALL_SPACE, seed=seed).fit(rows)
    port = PCM.CostModel(SMALL_SPACE, seed=seed, device="cpu").fit(rows)
    assert port.n_train == ref.n_train
    assert (port._y_mean, port._y_std) == (ref._y_mean, ref._y_std)
    np.testing.assert_allclose(_grid_predictions(port, "port"),
                               _grid_predictions(ref, "ref"),
                               rtol=PRED_RTOL)
    for (pw, pb), (jw, jb) in zip(port.params, ref.params):
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-4,
                                   atol=1e-6)


def test_fit_permutation_invariant_and_state_roundtrip_bitwise():
    fn = seeded_objective(3, SMALL_SPACE)
    rows = _rows("port", fn, SMALL_SPACE, 3, n=80)
    shuffled = list(rows)
    np.random.default_rng(7).shuffle(shuffled)
    m1 = PCM.CostModel(SMALL_SPACE, epochs=120, device="cpu").fit(rows)
    m2 = PCM.CostModel(SMALL_SPACE, epochs=120, device="cpu").fit(shuffled)
    probe = [DEFAULT_TUNABLES,
             DEFAULT_TUNABLES.replace(remat="full", microbatches=8)]
    assert np.array_equal(m1.predict(probe), m2.predict(probe))
    state = json.loads(json.dumps(m1.export_state()))
    m3 = PCM.CostModel.from_state(state, device="cpu")
    assert np.array_equal(m3.predict(probe), m1.predict(probe))
    assert m3.n_train == m1.n_train
    with pytest.raises(RuntimeError, match="before fit"):
        PCM.CostModel(SMALL_SPACE, device="cpu").predict(probe)
    with pytest.raises(ValueError, match="no usable trace rows"):
        PCM.CostModel(SMALL_SPACE, device="cpu").fit([({"remat": "x"}, 1.0)])


def test_state_crosses_packages():
    """A fitted reference model carried into the port (``convert`` and the
    state layout) and a port model read by the reference predict alike;
    the state dicts are the same tree."""
    fn = seeded_objective(1, SMALL_SPACE)
    rows = _rows("port", fn, SMALL_SPACE, 1, n=60)
    ref = JCM.CostModel(SMALL_SPACE, epochs=100).fit(rows)
    port = convert.cost_model_from_jax(ref, device="cpu")
    assert json.dumps(port.export_state()) == json.dumps(ref.export_state())
    np.testing.assert_allclose(_grid_predictions(port, "port"),
                               _grid_predictions(ref, "ref"), rtol=1e-6)
    own = PCM.CostModel(SMALL_SPACE, epochs=100, device="cpu").fit(rows)
    back = JCM.CostModel.from_state(json.loads(json.dumps(
        own.export_state())))
    np.testing.assert_allclose(_grid_predictions(back, "ref"),
                               _grid_predictions(own, "port"), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_search_equal_reference(reference_init, seed):
    """The bench's eval-budget gate in both packages: the same winner, cost,
    evaluations and PluginStats, the committed cost the oracle's, within
    10 % of the grid (+1 for the incumbent probe)."""
    kw = dict(model_guided=True, significance=0.1, eval_budget=0.1)
    jp, jc, fn, _ = _scenario("ref", seed, **kw)
    pp, pc, _, pdb = _scenario("port", seed, **kw)
    want = jp.on_resource_request(fn, jc)
    got = pp.on_resource_request(fn, pc)
    assert got.as_dict() == want.as_dict()
    assert vars(pp.stats) == vars(jp.stats)
    assert pp.stats.model_searches == 1 and pp.stats.model_fallbacks == 0
    _, oracle_cost = exhaustive_oracle(fn, DEFAULT_SPACE)
    assert fn(got) == oracle_cost
    assert pp.stats.evaluations <= int(0.1 * 5184) + 1
    assert pdb.get_sensitivity(pc.current_label) == \
        jp.db.get_sensitivity(jc.current_label)
    assert pdb.get_trace(pc.current_label) == \
        jp.db.get_trace(jc.current_label)
    assert pp._model_label == jp._model_label


@pytest.mark.parametrize("seed", [0, 1])
def test_model_guided_off_bit_identical(seed):
    """``model_guided=False`` reproduces the unmodelled Plan whatever the
    model knobs say, and both equal the reference's."""
    base, ctx_a, fn, _ = _scenario("port", seed)
    off, ctx_b, _, _ = _scenario(
        "port", seed, model_guided=False, significance=0.5,
        regret_bound=0.01, min_trace=1, eval_budget=0.5)
    ref, ctx_r, _, _ = _scenario("ref", seed)
    best_a = base.on_resource_request(fn, ctx_a)
    best_b = off.on_resource_request(fn, ctx_b)
    best_r = ref.on_resource_request(fn, ctx_r)
    assert best_a == best_b and fn(best_a) == fn(best_b)
    assert vars(base.stats) == vars(off.stats) == vars(ref.stats)
    assert best_a.as_dict() == best_r.as_dict()
    assert off._cost_model is None


@pytest.mark.parametrize("case", ["cold", "mistrusted"])
def test_model_fallbacks_equal_reference(reference_init, case):
    """A cold model (too few rows) and a mistrusted one (anti-correlated
    costs) both fall back to the unmodelled branch, as in the reference."""
    kw = dict(model_guided=True, significance=0.0, regret_bound=0.25,
              trace_rows=0 if case == "cold" else 300,
              adversarial=case == "mistrusted")
    runs = []
    for pkg in ("ref", "port"):
        plug, ctx, fn, _ = _scenario(pkg, 0, **kw)
        runs.append((plug.on_resource_request(fn, ctx).as_dict(),
                     vars(plug.stats).copy()))
    assert runs[0] == runs[1]
    assert runs[1][1]["model_fallbacks"] == 1
    assert runs[1][1]["model_searches"] == 0


def test_plan_model_state_survives_session_checkpoint(tmp_path):
    """The v2 schema's Plan section: a trained cost model and the label it
    was fitted for come back from a port snapshot with bit-equal
    predictions, and the reference reads the same snapshot."""
    from repro.kermit import KermitSession as JKermitSession
    from repro_torch.kermit import (AnalysisConfig, KermitConfig,
                                    KermitSession, MonitorConfig, PlanConfig,
                                    SimulatorExecutor)
    space = {"microbatches": [1, 2, 4], "remat": ["dots", "none"]}
    cfg = KermitConfig(monitor=MonitorConfig(window_size=8),
                       analysis=AnalysisConfig(interval=8, min_windows=6),
                       plan=PlanConfig(space=space))
    ex = SimulatorExecutor([("dense_train", 10)], window_size=8,
                           device="cpu")
    s = KermitSession(cfg, executor=ex, device="cpu")
    s.run()
    rng = np.random.default_rng(0)
    rows = [(s.plugin.explorer._decode_index(DEFAULT_TUNABLES, int(i))
             .as_dict(), float(rng.uniform(1, 2))) for i in range(6)]
    label = next(iter(s.db.records))
    s.db.record_trace(label, rows)
    s.db.set_sensitivity(label, PCM.knob_sensitivity(rows, space))
    s.plugin._cost_model = PCM.CostModel(space, epochs=60,
                                         device="cpu").fit(rows)
    s.plugin._model_label = label
    snap = tmp_path / "snap.npz"
    s.checkpoint(snap)
    r = KermitSession.restore(snap, device="cpu")
    probe = [DEFAULT_TUNABLES, DEFAULT_TUNABLES.replace(microbatches=4)]
    assert r.plugin._model_label == label
    assert np.array_equal(r.plugin._cost_model.predict(probe),
                          s.plugin._cost_model.predict(probe))
    assert r.db.get_trace(label) == s.db.get_trace(label)
    assert r.db.get_sensitivity(label) == s.db.get_sensitivity(label)
    j = JKermitSession.restore(snap)
    np.testing.assert_allclose(
        j.plugin._cost_model.predict(
            [J_DEFAULT, J_DEFAULT.replace(microbatches=4)]),
        s.plugin._cost_model.predict(probe), rtol=1e-6)
