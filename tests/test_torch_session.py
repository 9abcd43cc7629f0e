"""The slice as a whole: the quickstart loop (KermitSession +
SimulatorExecutor) through the JAX reference and through the port.

With the reference's random draws injected into the port, every decision
is bit-equal: ANALYSIS events (clusters, new and drifted labels), the
RETUNE stream, the Plan phase's searches (winners, costs, evaluation
counts) and the final tunables.  The port's own run, with its own draws,
meets the quickstart's asserts.
"""
import itertools

import numpy as np
import pytest

from repro.core.explorer import DEFAULT_SPACE
from repro.core.explorer import Explorer as JExplorer
from repro.configs.base import DEFAULT_TUNABLES as J_DEFAULT
from repro.core.simulator import random_schedule
from repro.kermit import executor as JX
from repro.kermit import (AnalysisConfig as JAnalysisConfig,
                          KermitConfig as JKermitConfig,
                          KermitSession as JKermitSession,
                          MonitorConfig as JMonitorConfig,
                          PlanConfig as JPlanConfig,
                          SimulatorExecutor as JSimulatorExecutor)
from repro_torch.configs.base import DEFAULT_TUNABLES
from repro_torch.core.explorer import Explorer
from repro_torch.kermit import (AnalysisConfig, EventKind, KermitConfig,
                                KermitSession, MonitorConfig, PlanConfig,
                                SimulatorExecutor)
from repro_torch.kermit import executor as PX
from torch_parity import reference_draws  # noqa: F401 (fixture)

QUICKSTART = [("dense_train", 12), ("decode_serve", 12), ("dense_train", 8)]
LONG = random_schedule(7, min_len=8, max_len=14, seed=3,
                       subset=["dense_train", "decode_serve", "eval_loop",
                               "ingest_bound"])


def _config(pkg, interval):
    Kc, Mc, Ac, Pc = pkg
    return Kc(monitor=Mc(window_size=16),
              analysis=Ac(interval=interval, dbscan_eps=0.3),
              plan=Pc(space={"microbatches": [1, 2, 4],
                             "remat": ["dots", "none"]}))


def _run(session_cls, config, executor, **kw):
    with session_cls(config, executor=executor, **kw) as s:
        final = s.run()
        events = [(e.window_id, str(e.kind), e.label, e.tunables,
                   {k: v for k, v in e.detail.items() if k != "seconds"})
                  for e in s.events]
        db = {label: (r.config, r.has_optimal, r.is_synthetic, r.pair)
              for label, r in s.db.records.items()}
        summary = s.summary()
    return final.as_dict(), events, db, summary


@pytest.mark.parametrize("schedule,interval", [(QUICKSTART, 8), (LONG, 32)])
def test_session_decisions_match_reference(reference_draws, schedule,
                                           interval):
    ref = _run(JKermitSession,
               _config((JKermitConfig, JMonitorConfig, JAnalysisConfig,
                        JPlanConfig), interval),
               JSimulatorExecutor(schedule, window_size=16, seed=0))
    port = _run(KermitSession,
                _config((KermitConfig, MonitorConfig, AnalysisConfig,
                         PlanConfig), interval),
                SimulatorExecutor(schedule, window_size=16, seed=0,
                                  device="cpu"), device="cpu")
    assert port[0] == ref[0]                          # final tunables
    assert port[1] == ref[1]                          # every event
    assert port[2] == ref[2]                          # knowledge base
    for key in ("windows", "known_workloads", "anticipated_hybrids",
                "plugin", "events"):
        assert port[3][key] == ref[3][key], key
    kinds = {e[1] for e in port[1]}
    assert {"analysis", "retune"} <= kinds


def test_quickstart_own_draws_meets_its_asserts():
    retunes = []
    config = _config((KermitConfig, MonitorConfig, AnalysisConfig,
                      PlanConfig), 8)
    assert KermitConfig.from_dict(config.to_dict()) == config
    ex = SimulatorExecutor(QUICKSTART, window_size=16, seed=0, device="cpu")
    with KermitSession(config, executor=ex, device="cpu") as session:
        session.subscribe(EventKind.RETUNE, retunes.append)
        tunables = session.run()
        summary = session.summary()
    assert summary["known_workloads"] >= 2
    assert retunes
    assert (tunables.microbatches, tunables.remat) == (2, "none")
    assert summary["last_analysis_seconds"] > 0


def test_analysis_report_times_its_parts():
    from repro_torch.core.analyser import KermitAnalyser
    from repro_torch.core.knowledge import WorkloadDB
    ex = SimulatorExecutor(QUICKSTART, window_size=16, seed=0, device="cpu")
    with KermitSession(_config((KermitConfig, MonitorConfig, AnalysisConfig,
                                PlanConfig), 64), executor=ex,
                       device="cpu") as session:
        session.run()
        ws = session.monitor.window_series(copy=True)
    rep = KermitAnalyser(WorkloadDB(device="cpu"), dbscan_eps=0.3,
                         device="cpu").run(ws)
    assert rep.clusters >= 2
    assert 0 < rep.dbscan_seconds <= rep.discover_seconds
    assert rep.forest_seconds > 0 and rep.predictor_seconds > 0
    assert rep.forest_seconds + rep.predictor_seconds <= rep.train_seconds


def _grid():
    g = np.array(list(itertools.product([0, 1, 2, 3, 4, 8, 16], [0, 1, 2],
                                        [256, 512, 1024, 2048, 4096])),
                 np.int32)
    return {"microbatches": g[:, 0], "remat": g[:, 1],
            "attn_q_chunk": g[:, 2]}


def test_simulator_cost_matches_reference_bitwise():
    got = PX._default_sim_cost_arrays(_grid(), device="cpu")
    np.testing.assert_array_equal(got, JX._default_sim_cost_arrays(_grid()))


@pytest.mark.parametrize("search", ["global_search", "local_search",
                                    "exhaustive"])
def test_explorer_over_simulator_matches_reference(search):
    space = dict(DEFAULT_SPACE)
    jx = JSimulatorExecutor(QUICKSTART, window_size=16)
    px = SimulatorExecutor(QUICKSTART, window_size=16, device="cpu")
    from repro.kermit.executor import ExecutorObjective as JObj
    from repro_torch.kermit.executor import ExecutorObjective as PObj
    start = DEFAULT_TUNABLES.replace(microbatches=8, attn_q_chunk=2048)
    want = getattr(JExplorer(space), search)(
        JObj(jx), J_DEFAULT.replace(microbatches=8, attn_q_chunk=2048))
    got = getattr(Explorer(space), search)(PObj(px), start)
    assert got.best.as_dict() == want.best.as_dict()
    assert (got.cost, got.evaluations) == (want.cost, want.evaluations)
    assert got.trace == want.trace
    assert (px.measured, px.measured_batches) == \
        (jx.measured, jx.measured_batches)


def test_deferred_paths_raise():
    ex = SimulatorExecutor(QUICKSTART, window_size=16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KermitSession(KermitConfig(impl="legacy"), executor=ex, device="cpu")
    s = KermitSession(KermitConfig(), executor=ex, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        s.checkpoint("x.npz")
    with pytest.raises(NotImplementedError):
        KermitSession.restore("x.npz")
    s.close()
