"""The Trainer (``repro_torch.runtime.loop``) against the JAX package:
``examples/autonomic_train.py``'s schedule and ``examples/fault_tolerance.py``
at tiny widths, and the training launcher.

Wall-clock step times never agree between two packages, and KERMIT's
decisions depend on them, so the schedule runs both Trainers under one
step clock (as ``tests/test_torch_serving.py`` fixes both engines'
timings): each package's loop and pipeline read a clock that only a train
step advances, by a fixed cost of its tunables and shape.  The steps
themselves run, trials included.  Both Trainers start from the same
weights (the reference's, converted) and the reference's random draws
are injected into the port's forest and LSTM fits (``reference_draws``),
so ANALYSIS/RETUNE events, retunes and final tunables must be equal.

The fault-tolerance run recovers twice in both packages and its losses
agree step by step to rtol 1e-5 (fp32; autograd and XLA sum in other
orders).
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.data.pipeline as JP
import repro.runtime.loop as JL
import repro_torch.data.pipeline as PP
import repro_torch.runtime.loop as PL
from repro.configs.base import DEFAULT_TUNABLES as J_DEFAULT
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.kermit import AnalysisConfig as JAnalysisConfig
from repro.kermit import KermitConfig as JKermitConfig
from repro.kermit import KermitSession as JKermitSession
from repro.kermit import MonitorConfig as JMonitorConfig
from repro.kermit import PlanConfig as JPlanConfig
from repro.optim.adamw import OptConfig as JOptConfig
from repro.runtime.fault import FailureInjector as JFailureInjector
from repro_torch.configs.base import DEFAULT_TUNABLES, ShapeSpec, reduced
from repro_torch.configs.registry import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.kermit import (AnalysisConfig, KermitConfig, KermitSession,
                                MonitorConfig, PlanConfig)
from repro_torch.optim.adamw import OptConfig, tree_leaves
from repro_torch.runtime.fault import FailureInjector
from torch_parity import reference_draws  # noqa: F401 (fixture)

# examples/autonomic_train.py:31-40, at tiny shapes
LIVE_SPACE = {"remat": ["dots", "none", "full"], "microbatches": [1, 2, 4],
              "attn_q_chunk": [64, 128, 256]}
PHASES = [("qwen2-1.5b", 32, 8), ("mamba2-1.3b", 64, 4)]
STEPS = 24      # two phases of 6 windows: ANALYSIS at window 10


class StepClock:
    """``time`` for a loop module: ``perf_counter`` reads a clock that
    only the train steps built through ``make_train_step`` advance."""

    def __init__(self):
        self.now = 0.0
        self.shape = None

    def perf_counter(self) -> float:
        return self.now

    def cost(self, tun) -> float:
        r = {"none": 1.0, "dots": 1.15, "full": 1.3}[tun.remat]
        m = {1: 1.1, 2: 1.0, 4: 1.05}[tun.microbatches]
        q = {64: 1.03, 128: 1.0, 256: 1.01, 1024: 1.02}[tun.attn_q_chunk]
        return 1e-3 * self.shape.seq_len * self.shape.global_batch / 64 \
            * r * m * q


def _clocked(monkeypatch, loop, pipe, jit):
    """Put ``loop`` and ``pipe`` on a StepClock; with ``jit`` (the
    reference) the loop's ``jax.jit`` keeps one compiled step per
    (config, tunables), so repeated trials compile once."""
    clock = StepClock()
    real = loop.make_train_step
    cache = {}

    def make_train_step(cfg, oc, tun, **kw):
        fn = real(cfg, oc, tun, **kw)
        if jit:
            fn = cache.setdefault((cfg, oc, tun), jax.jit(fn))

        def step(state, batch):
            out = fn(state, batch)
            clock.now += clock.cost(tun)
            return out
        return step
    monkeypatch.setattr(loop, "make_train_step", make_train_step)
    monkeypatch.setattr(loop, "time", clock)
    monkeypatch.setattr(pipe, "time", clock)
    if jit:
        class NoJit:                  # the steps above are compiled
            def __getattr__(self, name):
                return getattr(jax, name)

            @staticmethod
            def jit(fn, **kw):
                return fn
        monkeypatch.setattr(loop, "jax", NoJit())
    return clock


def _run_schedule(session, trainer, clock, tiny, shape_cls, oc, states):
    reps = []
    for i, (arch, S, B) in enumerate(PHASES):
        cfg = tiny(arch)
        clock.shape = shape_cls("p", S, B, "train")
        tr = trainer(cfg, clock.shape, oc, i)
        if states is not None:
            if i not in states:
                states[i] = jax.tree_util.tree_map(np.asarray, tr.state)
            else:
                tr.state = train_state_from_jax(states[i], device="cpu")
        reps.append(tr.run(STEPS))
    return reps


def _events(session):
    return [(e.window_id, str(e.kind), e.label,
             None if e.tunables is None else sorted(e.tunables.items()))
            for e in session.events]


def test_autonomic_schedule_equals_reference_under_one_clock(
        monkeypatch, reference_draws, tmp_path):  # noqa: F811
    states = {}
    jclock = _clocked(monkeypatch, JL, JP, jit=True)
    jsession = JKermitSession(JKermitConfig(
        monitor=JMonitorConfig(window_size=4),
        analysis=JAnalysisConfig(interval=5, dbscan_eps=0.25),
        plan=JPlanConfig(space=LIVE_SPACE)))
    jreps = _run_schedule(
        jsession, lambda cfg, shape, oc, i: JL.Trainer(
            cfg, shape, oc, J_DEFAULT, autonomic=jsession, seed=i),
        jclock, lambda a: j_reduced(j_get_config(a)).replace(n_layers=2,
                                                             vocab=256),
        JShapeSpec, JOptConfig(lr=1e-3, warmup=5), states)

    pclock = _clocked(monkeypatch, PL, PP, jit=False)
    psession = KermitSession(KermitConfig(
        monitor=MonitorConfig(window_size=4),
        analysis=AnalysisConfig(interval=5, dbscan_eps=0.25),
        plan=PlanConfig(space=LIVE_SPACE)), device="cpu")
    preps = _run_schedule(
        psession, lambda cfg, shape, oc, i: PL.Trainer(
            cfg, shape, oc, DEFAULT_TUNABLES, autonomic=psession, seed=i,
            device="cpu"),
        pclock, lambda a: reduced(get_config(a)).replace(n_layers=2,
                                                         vocab=256),
        ShapeSpec, OptConfig(lr=1e-3, warmup=5), states)

    kinds = [e[1] for e in _events(psession)]
    assert "analysis" in kinds and "retune" in kinds
    assert _events(psession) == _events(jsession)
    assert psession.summary()["plugin"] == jsession.summary()["plugin"]
    for p, j in zip(preps, jreps):
        assert p.retunes == j.retunes and p.final_tunables == j.final_tunables
        assert p.analysis_events == j.analysis_events
        assert p.failed_trials == 0
        np.testing.assert_allclose(p.losses, j.losses, rtol=1e-5)
    assert pclock.now == jclock.now
    psession.close()
    jsession.close()


def test_fault_tolerance_example_matches_reference(tmp_path):
    """examples/fault_tolerance.py: reduced qwen3-14b (2 layers, vocab
    256), checkpoints every 5 steps, failures at steps 8 and 17."""
    shape = (128, 4)
    jcfg = j_reduced(j_get_config("qwen3-14b")).replace(n_layers=2,
                                                        vocab=256)
    jtr = JL.Trainer(jcfg, JShapeSpec("ft", *shape, "train"),
                     JOptConfig(lr=1e-3), J_DEFAULT,
                     ckpt_dir=tmp_path / "j", ckpt_every=5,
                     injector=JFailureInjector(fail_steps=(8, 17)))
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jtr.state),
                                 device="cpu")
    jrep = jtr.run(25)
    cfg = reduced(get_config("qwen3-14b")).replace(n_layers=2, vocab=256)
    tr = PL.Trainer(cfg, ShapeSpec("ft", *shape, "train"),
                    OptConfig(lr=1e-3), DEFAULT_TUNABLES,
                    ckpt_dir=tmp_path / "p", ckpt_every=5,
                    injector=FailureInjector(fail_steps=(8, 17)),
                    device="cpu")
    tr.state = state
    rep = tr.run(25)
    assert rep.steps_done == jrep.steps_done == 25
    assert rep.failures_recovered == jrep.failures_recovered == 2
    assert len(rep.losses) == len(jrep.losses) == 30
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=1e-5)
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


def test_trainer_device_rule_and_mesh():
    """A Trainer on the one-device host mesh sets the rules' mesh and
    trains bit-equal to one without; a mesh-less Trainer clears it; a
    non-mesh object raises."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules
    cfg = reduced(get_config("qwen2-1.5b")).replace(n_layers=2, vocab=256)
    shape = ShapeSpec("t", 32, 2, "train")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PL.Trainer(cfg, shape)
    with pytest.raises(TypeError, match="mesh"):
        PL.Trainer(cfg, shape, mesh=object(), device="cpu")
    mesh = make_host_mesh("cpu")
    runs = {}
    for m in (mesh, None):
        tr = PL.Trainer(cfg, shape, mesh=m, device="cpu")
        assert rules.current_mesh() is m
        try:
            rep = tr.run(2)
        finally:
            tr.pipeline.close()
        runs[m is None] = (rep.losses, [p.clone() for p in
                                        tree_leaves(tr.state["params"])])
    assert runs[False][0] == runs[True][0] and len(runs[True][0]) == 2
    assert all(torch.equal(a, b) for a, b in zip(runs[False][1],
                                                 runs[True][1]))


def test_failed_trials_cost_inf_and_are_counted():
    cfg = reduced(get_config("qwen2-1.5b")).replace(n_layers=2, vocab=256)
    tr = PL.Trainer(cfg, ShapeSpec("t", 32, 2, "train"), device="cpu")
    try:
        objective = tr.measured_objective()
        # 4 microbatches of a batch of 2 cannot be cut: the step raises
        assert objective(DEFAULT_TUNABLES.replace(microbatches=4)) == \
            float("inf")
        assert np.isfinite(objective(DEFAULT_TUNABLES))
    finally:
        tr.pipeline.close()
    assert tr.failed_trials == 1 and "microbatches" in str(
        tr.trial_errors[0][0])


def test_train_launcher_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--steps", "4", "--seq", "32", "--batch", "2",
          "--fail-at", "2", "--ckpt-dir", str(tmp_path),
          "--tun", "remat=full", "microbatches=2"])
    out = json.loads(capsys.readouterr().out)
    assert out["steps"] == 4 and out["device"] == "cpu"
    assert out["failures_recovered"] == 1 and out["failed_trials"] == 0
    assert np.isfinite(out["loss_last"])
