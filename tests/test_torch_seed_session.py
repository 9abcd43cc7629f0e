"""The seed path end to end — ``KermitSession(KermitConfig(impl="legacy"))``
— and the deprecated ``AutonomicManager`` shim, through the JAX reference
and through the port.

The reference's seed session compiles its eager ops anew for every shape,
so it runs once per module (a fixture) on a short schedule: 3 segments of
8 windows of 8 samples, an analysis every 8 windows.  With the
reference's draws injected the port's events, RETUNE stream, knowledge
base and final tunables are bit-equal to it.  The shim's events equal the
session's (after ``tests/test_kermit_session.py:144-171``); one mixed-flag
manager (fast monitor, seed analysis) is held to the reference's.
"""
import warnings

import pytest

from repro.core.autonomic import AutonomicManager as JManager
from repro.kermit import (AnalysisConfig as JAnalysisConfig,
                          KermitConfig as JKermitConfig,
                          KermitSession as JKermitSession,
                          MonitorConfig as JMonitorConfig,
                          PlanConfig as JPlanConfig,
                          SimulatorExecutor as JSimulatorExecutor)
from repro_torch.configs.base import Tunables
from repro_torch.core import AutonomicManager
from repro_torch.core.explorer import Explorer
from repro_torch.kermit import (AnalysisConfig, CallableExecutor, EventKind,
                                KermitConfig, KermitSession, MonitorConfig,
                                PlanConfig, SimulatorExecutor)
from repro_torch.kernels import pairdist as PK
from torch_parity import reference_draws  # noqa: F401 (fixture)

SCHEDULE = [("dense_train", 8), ("decode_serve", 8), ("dense_train", 8)]
SPACE = {"microbatches": [1, 2, 4], "remat": ["dots", "none"]}
QUICKSTART = [("dense_train", 12), ("decode_serve", 12), ("dense_train", 8)]


def _config(pkg, impl, window=8, interval=8):
    Kc, Mc, Ac, Pc = pkg
    return Kc(monitor=Mc(window_size=window),
              analysis=Ac(interval=interval, dbscan_eps=0.3),
              plan=Pc(space=SPACE), impl=impl)


REF = (JKermitConfig, JMonitorConfig, JAnalysisConfig, JPlanConfig)
PORT = (KermitConfig, MonitorConfig, AnalysisConfig, PlanConfig)


def _events(events):
    # "seconds" is wall time — everything else must be bit-equal
    return [(e.window_id, str(e.kind), e.label, e.tunables,
             {k: v for k, v in e.detail.items() if k != "seconds"})
            for e in events]


def _run(session):
    with session as s:
        final = s.run()
        db = {label: (r.config, r.has_optimal, r.is_synthetic, r.pair)
              for label, r in s.db.records.items()}
        summary = s.summary()
    return final.as_dict(), _events(s.events), db, summary


@pytest.fixture(scope="module")
def reference_legacy():
    return _run(JKermitSession(_config(REF, "legacy"), executor=
                               JSimulatorExecutor(SCHEDULE, window_size=8,
                                                  seed=0)))


def _port(impl, **kw):
    ex = SimulatorExecutor(SCHEDULE, window_size=8, seed=0, device="cpu")
    return _run(KermitSession(_config(PORT, impl), executor=ex,
                              device="cpu", **kw))


def test_legacy_session_matches_reference(reference_draws, reference_legacy):
    PK.DENSE_LAUNCHES = PK.LAUNCHES = 0
    port = _port("legacy")
    ref = reference_legacy
    assert port[0] == ref[0]                          # final tunables
    assert port[1] == ref[1]                          # every event
    assert port[2] == ref[2]                          # knowledge base
    for key in ("windows", "known_workloads", "anticipated_hybrids",
                "plugin", "events"):
        assert port[3][key] == ref[3][key], key
    kinds = [e[1] for e in port[1]]
    assert {"analysis", "retune", "transition"} <= set(kinds)
    assert port[3]["impl"] == "legacy"
    # on the CPU the wrappers take the plain versions: no kernel launched
    assert PK.DENSE_LAUNCHES == PK.LAUNCHES == 0


def test_seed_alias_and_fast_path_decide_alike(reference_legacy):
    legacy = _port("legacy")
    assert _port("seed")[:3] == legacy[:3]
    fast = _port("auto")
    assert fast[0] == legacy[0]
    assert [e for e in fast[1] if e[1] == "retune"] == \
        [e for e in legacy[1] if e[1] == "retune"]


def test_legacy_quickstart_own_draws_meets_its_asserts():
    retunes = {}
    for impl in ("auto", "legacy"):
        ex = SimulatorExecutor(QUICKSTART, window_size=16, seed=0,
                               device="cpu")
        config = _config(PORT, impl, window=16)
        with KermitSession(config, executor=ex, device="cpu") as session:
            got = []
            session.subscribe(EventKind.RETUNE, got.append)
            tunables = session.run()
            summary = session.summary()
        assert summary["known_workloads"] >= 2
        assert got
        assert (tunables.microbatches, tunables.remat) == (2, "none")
        retunes[impl] = [(e.window_id, e.tunables) for e in got]
    assert retunes["legacy"] == retunes["auto"]


def _objective(t: Tunables) -> float:
    return abs(t.microbatches - 2) + (0.0 if t.remat == "none" else 0.5)


def test_manager_shim_warns_and_matches_session_events():
    samples = SimulatorExecutor([("dense_train", 10), ("decode_serve", 10),
                                 ("dense_train", 6)], window_size=8, seed=15,
                                device="cpu").samples
    with pytest.warns(DeprecationWarning, match="AutonomicManager"):
        mgr = AutonomicManager(window_size=8, analysis_interval=10,
                               dbscan_eps=0.35, explorer=Explorer(SPACE),
                               device="cpu")
    with mgr:
        for s in samples:
            mgr.step(s, _objective)
    config = KermitConfig(monitor=MonitorConfig(window_size=8),
                          analysis=AnalysisConfig(interval=10,
                                                  dbscan_eps=0.35),
                          plan=PlanConfig(space=SPACE))
    with KermitSession(config, executor=CallableExecutor(_objective),
                       device="cpu") as sess:
        sess.step_batch(samples)
    assert _events(mgr.events) == _events(sess.events)
    assert any(e.kind == "retune" for e in sess.events)
    assert mgr.current == sess.current
    assert mgr.events_total == sess.events_total
    assert mgr.summary()["windows"] == sess.summary()["windows"]


def test_manager_mixed_flags_match_reference(reference_draws,
                                             reference_legacy):
    """Fast monitor + seed analysis (the reference's compilations of the
    module's seed session are reused: same windows, same shapes)."""
    samples = JSimulatorExecutor(SCHEDULE, window_size=8, seed=0).samples
    kw = dict(window_size=8, analysis_interval=8, dbscan_eps=0.3,
              fast_monitor=True, fast_analysis=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = JManager(**kw)
        port = AutonomicManager(device="cpu", **kw)
    assert (port.monitor.fast, port.analyser.fast,
            port.analyser.dbscan_impl) == (True, False, "legacy")
    out = []
    for mgr in (ref, port):
        with mgr:
            mgr.step_batch(samples, _objective)
            out.append((mgr.current.as_dict(), _events(mgr.events),
                        mgr.summary()["known_workloads"]))
    assert out[1] == out[0]
    assert any(e[1] == "analysis" for e in out[1][1])
