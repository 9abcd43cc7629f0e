"""The port's ``KermitFleet`` against the reference's and against isolated
port sessions.

With the reference's draws injected into the port's fits, S tenants with
simulator executors (one of them behind a chaos straggler and a retry
layer) decide bit-equal to the reference fleet: the tenant-tagged event
stream, the monitor's labels, the committed tunables, every tenant's
stored configurations and ``FleetStats`` except ``traces`` (the
reference's XLA compilations; the port compiles nothing).  The same
tenants run as isolated port ``KermitSession``s decide as the fleet does.
Also: ``FleetConfig`` round trips, ingest buffering and the constructor's
refusals."""
import numpy as np
import pytest
import torch

import repro.kermit as J
import repro_torch.kermit as K
from torch_parity import reference_draws  # noqa: F401 (fixture)

W = 16
SPACE = {"microbatches": [1, 2, 4], "remat": ["dots", "none"],
         "grad_compression": [False, True]}
SCHED = [("dense_train", 14), ("moe_train", 14)]


def _config(M, **kw):
    return M.KermitConfig(
        monitor=M.MonitorConfig(window_size=W),
        analysis=M.AnalysisConfig(interval=8, min_windows=6),
        plan=M.PlanConfig(space=SPACE),
        knowledge=M.KnowledgeConfig(drift_eps=0.45), **kw)


def _executor(M, t, chaos_tenant, **kw):
    sim = M.SimulatorExecutor(SCHED, window_size=W, seed=t, **kw)
    if t != chaos_tenant:
        return sim
    chaos = M.ChaosExecutor(sim, [M.StragglerFault(at_window=18,
                                                   factor=3.0)],
                            seed=t, window_size=W)
    return M.ResilientExecutor(chaos, max_retries=2)


def _events(events):
    return [(e.window_id, str(e.kind), e.label, e.tunables, e.tenant,
             {k: v for k, v in e.detail.items() if k != "seconds"})
            for e in events]


def _stored(view):
    return {label: (r.config, r.has_optimal, r.is_synthetic)
            for label, r in view.records.items()}


@pytest.mark.parametrize("S,chaos_tenant,transfer", [
    (2, None, True), (3, 2, True), (3, 0, False)],
    ids=["S2", "S3_chaos", "S3_chaos_no_transfer"])
def test_fleet_equals_reference_fleet(reference_draws, S, chaos_tenant,
                                      transfer):
    want = J.KermitFleet(
        J.FleetConfig(tenants=S, base=_config(J), transfer=transfer),
        executors=lambda t: _executor(J, t, chaos_tenant))
    want.run()
    got = K.KermitFleet(
        K.FleetConfig(tenants=S, base=_config(K), transfer=transfer),
        executors=lambda t: _executor(K, t, chaos_tenant, device="cpu"),
        device="cpu")
    seen = []
    got.subscribe(None, seen.append)
    got.run()

    assert _events(got.events) == _events(want.events)
    assert _events(seen) == _events(want.events)
    kinds = {e.kind for e in got.events}
    assert {"analysis", "retune", "transition"} <= kinds
    if chaos_tenant is not None:
        assert {"fault", "recovery"} <= kinds
        assert {e.tenant for e in got.events if e.kind == "fault"} == \
            {chaos_tenant}
    ref_stats = {k: v for k, v in vars(want.stats).items() if k != "traces"}
    assert {k: v for k, v in vars(got.stats).items() if k != "traces"} == \
        ref_stats
    assert got.stats.traces == 0
    if transfer:
        assert got.stats.warm_transfers >= 1
    assert [t.as_dict() for t in got.current] == \
        [t.as_dict() for t in want.current]
    summ, ref_summ = got.summary(), want.summary()
    assert summ.keys() == ref_summ.keys()
    summ["stats"].pop("traces")
    ref_summ["stats"].pop("traces")
    assert summ == ref_summ
    meta, arrays = got.ring.export_state()
    rmeta, rarrays = want.ring.export_state()
    assert meta == rmeta
    for key in arrays:
        np.testing.assert_array_equal(arrays[key], rarrays[key])
    for t in range(S):
        assert _stored(got.tenant_db(t)) == _stored(want.tenant_db(t))
        assert vars(got.plugin_stats(t)) == vars(want.plugin_stats(t))
    assert [r.tenant for r in got.db.records.values()] == \
        [r.tenant for r in want.db.records.values()]


@pytest.mark.parametrize("chaos_tenant", [None, 1],
                         ids=["simulators", "chaos_tenant"])
def test_fleet_equals_isolated_sessions(reference_draws, chaos_tenant):
    """Labels, committed tunables and stored configurations equal S
    isolated sessions'; so does the event stream where no tenant is a
    chaos one.  A chaos tenant's FAULT lands one window later in the fleet
    than in a session, in both packages: a session's chaos clock is its
    monitor's window count, which ``step_batch`` advances a whole chunk
    before the chunk's contexts are processed (ROADMAP C4)."""
    S = 3
    fleet = K.KermitFleet(
        K.FleetConfig(tenants=S, base=_config(K)),
        executors=lambda t: _executor(K, t, chaos_tenant, device="cpu"),
        device="cpu")
    fleet.run()
    assert fleet.stats.ticks == len(fleet.ring.ordered(0)[2])
    for t in range(S):
        with K.KermitSession(_config(K), device="cpu", executor=_executor(
                K, t, chaos_tenant, device="cpu")) as sess:
            sess.run()
            np.testing.assert_array_equal(sess.monitor.label_log,
                                          fleet.ring.ordered(t)[2])
            mine = _events([e for e in fleet.events if e.tenant == t])
            theirs = _events(sess.events)
            if t == chaos_tenant:
                assert [x[1:4] for x in theirs] == [x[1:4] for x in mine]
                assert [x[0] for x in theirs if x[1] == "fault"] == \
                    [x[0] - 1 for x in mine if x[1] == "fault"]
            else:
                assert [x[:4] + x[5:] for x in theirs] == \
                    [x[:4] + x[5:] for x in mine]
            assert sess.current == fleet.current[t]
            assert _stored(fleet.tenant_db(t)) == _stored(sess.db)
    evals = sum(fleet.plugin_stats(t).evaluations for t in range(S))
    assert fleet.stats.warm_transfers >= 1 and evals > 0


def test_fleet_config_round_trips_with_the_reference():
    fc = K.FleetConfig(tenants=3, transfer=False, base=_config(K))
    ref = J.FleetConfig(tenants=3, transfer=False, base=_config(J))
    assert fc.to_dict() == ref.to_dict()
    assert K.FleetConfig.from_dict(fc.to_dict()) == fc
    assert K.FleetConfig.from_dict(ref.to_dict()) == fc
    assert J.FleetConfig.from_dict(fc.to_dict()) == ref
    assert K.FleetConfig.from_dict({}) == K.FleetConfig()
    with pytest.raises(ValueError, match="unknown FleetConfig"):
        K.FleetConfig.from_dict({"tenant_count": 3})


def test_constructor_refusals(monkeypatch):
    with pytest.raises(ValueError, match="legacy"):
        K.KermitFleet(K.FleetConfig(base=K.KermitConfig(impl="legacy")),
                      device="cpu")
    with pytest.raises(ValueError, match="at least one tenant"):
        K.KermitFleet(K.FleetConfig(tenants=0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        K.KermitFleet(K.FleetConfig(tenants=2))
    fleet = K.KermitFleet(K.FleetConfig(tenants=2), device="cpu")
    assert fleet.device.type == "cpu" and fleet.db.device.type == "cpu"
    assert all(t.analyser.device.type == "cpu" for t in fleet._tenants)


def test_cpu_strategies_are_refused_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(K.fleet, "resolve_device",
                        lambda d: torch.device("cuda"))
    for impl in ("xla", "pallas_interpret"):
        with pytest.raises(ValueError, match="CPU kernel strategy"):
            K.KermitFleet(K.FleetConfig(base=K.KermitConfig(impl=impl)))


def test_ingest_buffers_partial_windows():
    fleet = K.KermitFleet(K.FleetConfig(tenants=2, base=K.KermitConfig(
        monitor=K.MonitorConfig(window_size=W))), device="cpu")
    rng = np.random.default_rng(1)
    half = rng.normal(size=(2, W // 2, 16)).astype(np.float32)
    fleet.ingest(half)
    assert fleet.pending_samples == W // 2 and fleet.ring is None
    assert fleet.tenant_db(0).records == {}
    fleet.ingest(half)                       # completes one window per tenant
    assert fleet.pending_samples == 0
    assert fleet.ring is not None and fleet.ring.total == 1
    assert fleet.stats.ticks == fleet.stats.dispatches == 1
    fleet.ingest(np.concatenate([half, half, half], axis=1))
    assert fleet.ring.total == 2 and fleet.pending_samples == W // 2
    with pytest.raises(ValueError, match="tenants=2"):
        fleet.ingest(np.zeros((3, W, 16), np.float32))


def test_run_rejects_unequal_traces_and_missing_streams():
    fleet = K.KermitFleet(K.FleetConfig(tenants=2), device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        fleet.run([np.zeros((32, 16), np.float32),
                   np.zeros((48, 16), np.float32)])
    with pytest.raises(ValueError, match="needs traces"):
        fleet.run()


def test_duck_typed_classifier_is_refused():
    fleet = K.KermitFleet(K.FleetConfig(tenants=2, base=K.KermitConfig(
        monitor=K.MonitorConfig(window_size=W))), device="cpu")
    fleet._tenants[1].monitor.classifier = object()
    with pytest.raises(TypeError, match="RandomForest"):
        fleet.ingest(np.zeros((2, W, 16), np.float32))
