"""The chaos and resilience layers of the port against the reference.

The same seeded fault schedule drives a reference ``ChaosExecutor`` over the
reference's simulator and a port ``ChaosExecutor`` over the port's: every
cost, raise and journal entry is equal, fault by fault, because both draw
from the same counter-keyed ``np.random.default_rng`` calls.  The retry
schedule of ``ResilientExecutor`` (its deterministic jitter) is equal too,
and with no faults both layers pass every search through bit for bit.
"""
import json

import numpy as np
import pytest

from repro.configs.base import (DEFAULT_TUNABLES as J_DEFAULT,
                                tunables_to_arrays as j_arrays)
from repro.core.explorer import Explorer as JExplorer
from repro.kermit import chaos as JC
from repro.kermit import (ExecutorObjective as JObjective,
                          SimulatorExecutor as JSimulatorExecutor)
from repro.runtime.fault import SimulatedNodeFailure as JNodeFailure
from repro_torch.configs.base import DEFAULT_TUNABLES, tunables_to_arrays
from repro_torch.core.explorer import Explorer
from repro_torch.kermit import chaos as PC
from repro_torch.kermit import ExecutorObjective, SimulatorExecutor
from repro_torch.runtime.fault import SimulatedNodeFailure

SPACE = {"microbatches": [1, 2, 4], "remat": ["dots", "none"],
         "grad_compression": [False, True]}
WS = 8


def _sims(n_windows=6, seed=0):
    return (JSimulatorExecutor([("dense_train", n_windows)], window_size=WS,
                               seed=seed),
            SimulatorExecutor([("dense_train", n_windows)], window_size=WS,
                              seed=seed, device="cpu"))


FAULTS = {
    "straggler": {"kind": "straggler", "at_window": 1, "factor": 3.0,
                  "duration": 3},
    "transient": {"kind": "transient", "at_window": 0, "rate": 0.3,
                  "fail_steps": [2]},
    "noise": {"kind": "noise", "at_window": 1, "scale": 0.05},
    "stuck_knob": {"kind": "stuck_knob", "at_window": 2,
                   "knob": "microbatches", "value": 1},
    "crash": {"kind": "crash", "at_window": 3},
}


def _drive(mod, sim, tun, to_arrays, fault, seed):
    """A fixed sequence of Executor calls over five windows of the chaos
    clock; every outcome (cost, raise, journal entry) in order."""
    chaos = mod.ChaosExecutor(sim, [mod.fault_from_dict(fault)], seed=seed,
                              window_size=WS)
    cands = [tun.replace(microbatches=m, grad_compression=g)
             for m in (1, 2, 4) for g in (False, True)]
    out = []

    def call(name, fn):
        try:
            got = fn()
            out.append((name, np.asarray(got, np.float64).tolist()))
        except Exception as e:          # noqa: BLE001 — outcomes compared
            out.append((name, type(e).__name__, str(e)))
    for w in range(5):
        call("apply", lambda: (chaos.apply(cands[w % len(cands)]), 0.0)[1])
        for _ in range(3):
            call("measure", chaos.measure)
            call("batch", lambda: chaos.measure_batch(cands))
            call("arrays", lambda: chaos.measure_batch_arrays(
                to_arrays(cands)))
        out.append(("journal", json.loads(json.dumps(
            chaos.drain_fault_events()))))
        out.append(("current", chaos.current.as_dict()))
        chaos.advance(1)
    out.append(("state", json.loads(json.dumps(chaos.export_state()))))
    out.append(("injected", dict(chaos.injected)))
    return out, chaos


@pytest.mark.parametrize("kind", sorted(FAULTS))
@pytest.mark.parametrize("seed", [0, 5])
def test_fault_effect_and_journal_equal_reference(kind, seed):
    jsim, psim = _sims(seed=seed)
    want, jchaos = _drive(JC, jsim, J_DEFAULT, j_arrays, FAULTS[kind], seed)
    got, pchaos = _drive(PC, psim, DEFAULT_TUNABLES, tunables_to_arrays,
                         FAULTS[kind], seed)
    assert got == want
    np.testing.assert_array_equal(pchaos.samples, jchaos.samples)
    # the fault did something: a cost moved, a raise, or a pinned knob
    clean, _ = _drive(PC, _sims(seed=seed)[1], DEFAULT_TUNABLES,
                      tunables_to_arrays, {"kind": "noise", "at_window": 99},
                      seed)
    assert got != clean


def test_fault_specs_roundtrip_and_match_reference():
    for d in FAULTS.values():
        f = PC.fault_from_dict(json.loads(json.dumps(d)))
        assert PC.fault_from_dict(f.to_dict()) == f
        assert f.to_dict() == JC.fault_from_dict(d).to_dict()
    assert PC.STRAGGLER_TELEMETRY_DELTA == JC.STRAGGLER_TELEMETRY_DELTA
    with pytest.raises(ValueError, match="unknown fault kind"):
        PC.fault_from_dict({"kind": "meteor"})


def test_chaos_state_restores_across_packages():
    """A reference chaos layer's exported state, restored into the port's
    (through JSON, as a snapshot carries it), continues identically."""
    fault = [{"kind": "transient", "at_window": 0, "rate": 0.4},
             {"kind": "noise", "at_window": 0, "scale": 0.1}]
    jsim, psim = _sims()
    j = JC.ChaosExecutor(jsim, [JC.fault_from_dict(f) for f in fault],
                         seed=3, window_size=WS)
    for _ in range(6):
        try:
            j.measure_batch([J_DEFAULT])
        except JNodeFailure:
            pass
    p = PC.ChaosExecutor(psim, [PC.fault_from_dict(f) for f in fault],
                         seed=3, window_size=WS)
    p.restore_state(json.loads(json.dumps(j.export_state())))
    for _ in range(6):
        outs = []
        for ex, tun, err in ((j, J_DEFAULT, JNodeFailure),
                             (p, DEFAULT_TUNABLES, SimulatedNodeFailure)):
            try:
                outs.append(ex.measure_batch([tun]))
            except err as e:
                outs.append(str(e))
        assert outs[0] == outs[1]
    assert json.dumps(p.export_state()) == json.dumps(j.export_state())
    with pytest.raises(ValueError, match="faults"):
        PC.ChaosExecutor(psim, seed=3).restore_state(j.export_state())


class _AlwaysFails:
    current = None

    def __init__(self, error):
        self.error = error

    def apply(self, tunables):
        self.current = tunables

    def measure(self):
        raise self.error("down")


def _schedule(ex):
    return [dict(e) for e in ex.journal]


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_schedule_equal_reference(seed):
    j = JC.ResilientExecutor(_AlwaysFails(JNodeFailure), max_retries=3,
                             backoff_s=1e-5, seed=seed)
    p = PC.ResilientExecutor(_AlwaysFails(SimulatedNodeFailure),
                             max_retries=3, backoff_s=1e-5, seed=seed)
    for ex in (j, p):
        assert ex.measure() == float("inf")      # fallback cost
        assert ex.measure() == float("inf")
    assert _schedule(p) == _schedule(j)
    assert p.export_state() == j.export_state()
    delays = [e["delay_s"] for e in _schedule(p) if "delay_s" in e]
    assert len(delays) == 6 and len(set(delays)) == 6


def test_resilient_retries_through_transients_as_reference():
    """resilient(chaos(sim)) under a seeded transient rate: the same costs,
    retries, fallbacks and journal as the reference's stack."""
    jsim, psim = _sims()
    fault = {"kind": "transient", "at_window": 0, "rate": 0.5}
    j = JC.ResilientExecutor(JC.ChaosExecutor(
        jsim, [JC.fault_from_dict(fault)], seed=2), max_retries=2)
    p = PC.ResilientExecutor(PC.ChaosExecutor(
        psim, [PC.fault_from_dict(fault)], seed=2), max_retries=2)
    cands = [DEFAULT_TUNABLES.replace(microbatches=m) for m in (1, 2, 4)]
    jc = [J_DEFAULT.replace(microbatches=m) for m in (1, 2, 4)]
    for _ in range(8):
        assert p.measure_batch(cands) == j.measure_batch(jc)
        assert p.measure() == j.measure()
    assert (p.retries, p.fallbacks) == (j.retries, j.fallbacks)
    assert p.retries > 0
    assert _schedule(p) == _schedule(j)


def test_resilient_does_not_retry_other_errors():
    """``retry_on`` is the executor-fault types only: a RuntimeError (a CUDA
    error, an out-of-memory) propagates on the first attempt."""
    ex = PC.ResilientExecutor(_AlwaysFails(RuntimeError), max_retries=3)
    assert ex.retry_on == (SimulatedNodeFailure, TimeoutError)
    with pytest.raises(RuntimeError, match="down"):
        ex.measure()
    assert ex.retries == ex.fallbacks == 0


@pytest.mark.parametrize("search", ["global_search", "exhaustive"])
def test_zero_fault_pass_through_bit_identical(search):
    """resilient(chaos(sim)) with no fault: winner, cost, evaluation count
    and trace bit-identical to the bare simulator and to the reference's
    wrapped stack, and the same counters on the inner executor."""
    runs = []
    for wrap in (False, True):
        _, sim = _sims()
        ex = PC.ResilientExecutor(PC.ChaosExecutor(sim), max_retries=3) \
            if wrap else sim
        res = getattr(Explorer(SPACE), search)(ExecutorObjective(ex),
                                               DEFAULT_TUNABLES)
        runs.append((res.best.as_dict(), res.cost, res.evaluations,
                     list(res.trace), sim.measured, sim.measured_batches))
    assert runs[0] == runs[1]
    jsim, _ = _sims()
    jex = JC.ResilientExecutor(JC.ChaosExecutor(jsim), max_retries=3)
    want = getattr(JExplorer(SPACE), search)(JObjective(jex), J_DEFAULT)
    assert runs[1][:4] == (want.best.as_dict(), want.cost, want.evaluations,
                           list(want.trace))
    # the wrappers keep ``inner`` on the instance and delegate the rest
    chaos = PC.ChaosExecutor(_sims()[1])
    assert "inner" in vars(chaos) and chaos.samples.shape[1] == 16
    assert chaos.drain_fault_events() == []
