"""Durable sessions in the port: snapshots in the reference's format, read
both ways, the schema checks and migrations, and supervised
kill-and-restore.

A reference snapshot restored by the port decides as the reference's own
uninterrupted run, with the reference's draws injected into the port's
fits (events, monitor labels, winners, costs, evaluation counts, final
tunables), and the reference restores a snapshot the port wrote.  The
port's supervised run killed by a ``CrashFault`` decides bit for bit as
its run that never died.
"""
import numpy as np
import pytest

from repro.kermit import (AnalysisConfig as JAnalysisConfig,
                          ChaosExecutor as JChaosExecutor,
                          ExecConfig as JExecConfig,
                          KermitConfig as JKermitConfig,
                          KermitSession as JKermitSession,
                          KnowledgeConfig as JKnowledgeConfig,
                          MonitorConfig as JMonitorConfig,
                          PlanConfig as JPlanConfig,
                          ResilientExecutor as JResilientExecutor,
                          SimulatorExecutor as JSimulatorExecutor,
                          StragglerFault as JStragglerFault)
from repro_torch.kermit import (AnalysisConfig, ChaosExecutor, CrashFault,
                                EventKind, ExecConfig, KermitConfig,
                                KermitSession, KermitSupervisor,
                                KnowledgeConfig, MonitorConfig, PlanConfig,
                                ResilientExecutor, SessionCrash,
                                SimulatorExecutor, StragglerFault)
from repro_torch.kermit.session import CHECKPOINT_VERSION
from repro_torch.runtime.checkpoint import load_snapshot, save_snapshot
from torch_parity import reference_draws  # noqa: F401 (fixture)

SPACE = {"microbatches": [1, 2, 4], "remat": ["dots", "none"],
         "grad_compression": [False, True]}
WS = 8
PORT = (KermitConfig, MonitorConfig, AnalysisConfig, PlanConfig,
        KnowledgeConfig, ExecConfig)
REF = (JKermitConfig, JMonitorConfig, JAnalysisConfig, JPlanConfig,
       JKnowledgeConfig, JExecConfig)


def _cfg(pkg=PORT, **exec_kw):
    Kc, Mc, Ac, Pc, Knc, Ec = pkg
    return Kc(monitor=Mc(window_size=WS),
              analysis=Ac(interval=8, min_windows=6),
              plan=Pc(space=SPACE), knowledge=Knc(drift_eps=0.45),
              execute=Ec(**exec_kw))


def _stack(faults=(), n_windows=24, crash_at=None):
    """resilient(chaos(simulator)) in the port, on the CPU; a crash fault
    goes last so the other faults keep their indices and draws."""
    sim = SimulatorExecutor([("dense_train", n_windows)], window_size=WS,
                            seed=0, device="cpu")
    faults = list(faults) + ([CrashFault(at_window=crash_at)]
                             if crash_at is not None else [])
    chaos = ChaosExecutor(sim, faults, seed=0, window_size=WS)
    return ResilientExecutor(chaos, max_retries=2), chaos


def _ref_stack(n_windows=24):
    sim = JSimulatorExecutor([("dense_train", n_windows)], window_size=WS,
                             seed=0)
    chaos = JChaosExecutor(sim, [JStragglerFault(at_window=14, factor=3.0)],
                           seed=0, window_size=WS)
    return JResilientExecutor(chaos, max_retries=2), chaos


def _straggler():
    return [StragglerFault(at_window=14, factor=3.0)]


def _decisions(session):
    """Every decision of a run: events without RESTORE and CHECKPOINT (the
    durability mechanism's own trace) with their tunables and details (wall
    seconds and snapshot paths dropped), the monitor's labels, the Plan
    phase's counters and the final tunables."""
    evs = [e for e in session.events
           if e.kind not in (EventKind.RESTORE.value,
                             EventKind.CHECKPOINT.value)]
    return {
        "events": [(e.window_id, str(e.kind), e.label, e.tunables,
                    {k: v for k, v in e.detail.items()
                     if k not in ("seconds", "path")}) for e in evs],
        "labels": np.asarray(session.monitor.label_log).tolist(),
        "plugin": vars(session.plugin.stats).copy(),
        "final": session.current.as_dict(),
    }


CUT = 8 * WS           # an analysis boundary: both runs chunk alike


def test_port_restores_reference_snapshot_and_decides_as_reference(
        reference_draws, tmp_path):
    ex, chaos = _ref_stack()
    samples = np.asarray(chaos.samples)
    with JKermitSession(_cfg(REF), executor=ex) as whole:
        whole.step_batch(samples)
        want = _decisions(whole)
    ex, _ = _ref_stack()
    snap = tmp_path / "ref.npz"
    with JKermitSession(_cfg(REF), executor=ex) as head:
        head.step_batch(samples[:CUT])
        head.checkpoint(snap)
    port_ex, port_chaos = _stack(_straggler())
    np.testing.assert_array_equal(port_chaos.samples, samples)
    with KermitSession.restore(snap, executor=port_ex,
                               device="cpu") as tail:
        assert tail.events[-1].kind == EventKind.RESTORE.value
        tail.step_batch(samples[CUT:])
        got = _decisions(tail)
    assert got == want
    kinds = {e[1] for e in got["events"]}
    assert {"analysis", "fault", "recovery", "retune"} <= kinds


def test_reference_restores_port_snapshot(reference_draws, tmp_path):
    ex, chaos = _ref_stack()
    samples = np.asarray(chaos.samples)
    with JKermitSession(_cfg(REF), executor=ex) as whole:
        whole.step_batch(samples)
        want = _decisions(whole)
    port_ex, _ = _stack(_straggler())
    snap = tmp_path / "port.npz"
    with KermitSession(_cfg(), executor=port_ex, device="cpu") as head:
        head.step_batch(samples[:CUT])
        head.checkpoint(snap)
    ex, _ = _ref_stack()
    with JKermitSession.restore(snap, executor=ex) as tail:
        tail.step_batch(samples[CUT:])
        got = _decisions(tail)
    assert got == want


def test_snapshot_meta_and_arrays_match_reference_layout(reference_draws,
                                                         tmp_path):
    """The same run checkpointed by both packages: the same array keys,
    shapes and dtypes (bit-equal values), and the same meta tree apart
    from wall-clock fields and the path."""
    ex, chaos = _ref_stack()
    samples = np.asarray(chaos.samples)
    ref_snap, port_snap = tmp_path / "ref.npz", tmp_path / "port.npz"
    with JKermitSession(_cfg(REF), executor=ex) as s:
        s.step_batch(samples[:2 * CUT])
        s.checkpoint(ref_snap)
    port_ex, _ = _stack(_straggler())
    with KermitSession(_cfg(), executor=port_ex, device="cpu") as s:
        s.step_batch(samples[:2 * CUT])
        s.checkpoint(port_snap)
    ra, rm = load_snapshot(ref_snap)
    pa, pm = load_snapshot(port_snap)
    assert sorted(ra) == sorted(pa)
    for k in ra:
        assert (ra[k].shape, ra[k].dtype) == (pa[k].shape, pa[k].dtype), k
        np.testing.assert_array_equal(ra[k], pa[k], err_msg=k)

    def strip(meta):
        meta["session"]["last_analysis_seconds"] = None
        for e in meta["session"]["events"]:
            e["detail"].pop("seconds", None)
            e["detail"].pop("path", None)
        for c in meta["monitor"]["contexts"]:
            c["timestamp"] = 0.0
        for r in meta["knowledge"]["db"]["records"]:
            r["updated_at"] = 0.0
        for layer in meta["executor"]:
            layer["state"].pop("measure_seconds", None)
        return meta
    assert strip(pm) == strip(rm)


def test_port_kill_and_restore_bit_identical(tmp_path):
    def factory(crash_at):
        return lambda: _stack(_straggler(), crash_at=crash_at)[0]
    cfg = _cfg(checkpoint_every=4)
    clean = KermitSupervisor(cfg, factory(None),
                             checkpoint_path=tmp_path / "clean.npz",
                             device="cpu")
    clean_report = clean.run()
    crashed = KermitSupervisor(cfg, factory(17),
                               checkpoint_path=tmp_path / "crash.npz",
                               device="cpu")
    report = crashed.run()
    assert report["crashes"] == report["restores"] == 1
    assert report["windows"] == clean_report["windows"] == 24
    assert report["checkpoints"] == clean_report["checkpoints"]
    assert _decisions(crashed.session) == _decisions(clean.session)
    assert sum(e.kind == EventKind.RESTORE.value
               for e in crashed.session.events) == 1


def test_checkpoint_event_recorded_before_write(tmp_path):
    """The CHECKPOINT event is part of its own snapshot, so a restored
    stream replays it exactly where the uninterrupted stream has it."""
    ex, chaos = _stack(n_windows=10)
    s = KermitSession(_cfg(), executor=ex, device="cpu")
    s.step_batch(chaos.samples)
    snap = tmp_path / "snap.npz"
    s.checkpoint(snap)
    _, meta = load_snapshot(snap)
    last = meta["session"]["events"][-1]
    assert last["kind"] == EventKind.CHECKPOINT.value
    assert last["detail"] == {"path": str(snap), "window": 10,
                              "version": CHECKPOINT_VERSION}
    assert s.events[-1].kind == EventKind.CHECKPOINT.value


def test_restore_requires_matching_executor_stack(tmp_path):
    ex, chaos = _stack(n_windows=10)
    s = KermitSession(_cfg(), executor=ex, device="cpu")
    s.step_batch(chaos.samples)
    snap = tmp_path / "snap.npz"
    s.checkpoint(snap)
    sim = SimulatorExecutor([("dense_train", 10)], window_size=WS, seed=0,
                            device="cpu")
    # a bare chaos layer where the snapshot had resilient(chaos(sim))
    with pytest.raises(ValueError, match="layers"):
        KermitSession.restore(snap, executor=ChaosExecutor(sim, seed=0),
                              device="cpu")
    # three layers, the outer one of another type
    swapped = ChaosExecutor(ResilientExecutor(sim), seed=0)
    with pytest.raises(ValueError, match="does not match"):
        KermitSession.restore(snap, executor=swapped, device="cpu")
    # no executor: state restores, executor binding deferred
    s2 = KermitSession.restore(snap, device="cpu")
    assert s2.executor is None
    assert s2.monitor.windows_emitted == s.monitor.windows_emitted


def _checkpointed(tmp_path):
    ex, chaos = _stack(n_windows=10)
    s = KermitSession(_cfg(), executor=ex, device="cpu")
    s.step_batch(chaos.samples)
    snap = tmp_path / "snap.npz"
    s.checkpoint(snap)
    return snap


def _rewrite_meta(snap, mutate):
    arrays, meta = load_snapshot(snap)
    mutate(meta)
    save_snapshot(snap, arrays, meta)


@pytest.mark.parametrize("mutate,match", [
    (lambda m: m.update(flux_capacitor={"gw": 1.21}),
     rf"version {CHECKPOINT_VERSION} does not define fields "
     r"\['flux_capacitor'\]"),
    (lambda m: m.update(version=99), "version 99 is newer"),
    (lambda m: m.update(format="parquet"), "not a kermit-session snapshot"),
    (lambda m: m.update(version=-3), "no migration path"),
], ids=["unknown_field", "newer_version", "foreign_format", "unmigratable"])
def test_schema_rejections(tmp_path, mutate, match):
    snap = _checkpointed(tmp_path)
    _rewrite_meta(snap, mutate)
    with pytest.raises(ValueError, match=match):
        KermitSession.restore(snap, device="cpu")


def _downgrade_v0(m):
    m["version"] = 0
    del m["executor"]


def _downgrade_v1(m):
    m["version"] = 1
    del m["plugin"]["plan"]


@pytest.mark.parametrize("downgrade", [_downgrade_v0, _downgrade_v1],
                         ids=["v0", "v1"])
def test_forward_migrations(tmp_path, downgrade):
    """Old snapshots load through the one-version-at-a-time chain; the
    RESTORE event reports the post-migration version, and a pre-model
    (v1) snapshot comes back with no cost model."""
    snap = _checkpointed(tmp_path)
    _rewrite_meta(snap, downgrade)
    s = KermitSession.restore(snap, device="cpu")
    restore_ev = s.events[-1]
    assert restore_ev.kind == EventKind.RESTORE.value
    assert restore_ev.detail["version"] == CHECKPOINT_VERSION
    assert s.plugin._cost_model is None and s.plugin._model_label is None
    assert s.monitor.windows_emitted == 10


def test_supervisor_crash_before_first_checkpoint_cold_restarts(tmp_path):
    """Death before any snapshot exists replays from the beginning (cold
    start) instead of failing the run."""
    def build():
        return _stack(n_windows=12, crash_at=2)[0]
    sup = KermitSupervisor(_cfg(checkpoint_every=6), build,
                           checkpoint_path=tmp_path / "s.npz", device="cpu")
    report = sup.run()
    assert report["crashes"] == 1 and report["restores"] == 1
    assert report["windows"] == 12
    assert not any(e.kind == EventKind.RESTORE.value
                   for e in sup.session.events)  # cold restart, no snapshot


@pytest.mark.parametrize("source", ["argument", "config"])
def test_supervisor_max_restores_exhausted_raises(tmp_path, source):
    def build():
        return _stack(n_windows=12, crash_at=2)[0]
    kw = {"max_restores": 0} if source == "argument" else {}
    cfg = _cfg() if source == "argument" else _cfg(max_restores=0)
    sup = KermitSupervisor(cfg, build, checkpoint_path=tmp_path / "s.npz",
                           device="cpu", **kw)
    with pytest.raises(SessionCrash) as err:
        sup.run()
    assert err.value.window >= 2          # the chaos clock at death
    assert sup.crashes == 1 and sup.restores == 0


def test_supervisor_replays_no_other_error(tmp_path):
    """``restart_on`` is the manager's death only: an error of the managed
    system's device (here a RuntimeError from a measure) is not replayed."""
    class Broken(SimulatorExecutor):
        def measure(self, *a):
            raise RuntimeError("CUDA error: an illegal memory access")
        measure_batch = measure_batch_arrays = measure

    def build():
        sim = Broken([("dense_train", 12)], window_size=WS, seed=0,
                     device="cpu")
        return ResilientExecutor(ChaosExecutor(sim, seed=0), max_retries=2)
    sup = KermitSupervisor(_cfg(), build, checkpoint_path=tmp_path / "s.npz",
                           device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sup.run()
    assert sup.crashes == 0 and sup.restores == 0
