"""Training loop with the production spine: prefetching data pipeline, train
step, checkpoint/restart, failure injection + replay recovery, straggler
detection, telemetry, and the KERMIT autonomic hook (MAPE-K Execute = a new
step closure with the tunables the plug-in selects).

Port of ``repro/runtime/loop.py``.  The autonomic integration runs
through :class:`repro_torch.kermit.KermitSession`: the Trainer binds a
measured-step ``CallableExecutor`` (Execute phase) if the session has none,
subscribes to the typed event stream, and calls ``session.step(sample)``.
A deprecated ``AutonomicManager`` is accepted and unwrapped to its session.
``device=None`` means CUDA (raising without a card).

``mesh`` (a ``repro_torch.launch.mesh.Mesh`` on the Trainer's device type)
becomes the sharding rules' mesh, as in the reference; None clears it.
Under a mesh every rank runs the Trainer on the whole batch with the whole,
replicated state, as the reference's jitted step without ``in_shardings``
does; only the MoE's expert-parallel branch splits work over the ranks
(``models/moe.py``), and its backward hands every rank the whole gradient.

A measured trial runs the train step on the live state and drops the
result; the step never modifies its input, so the trial leaves the run as
it was (and ``Tunables.donate`` has nothing to give up).  A trial that
raises costs ``inf`` (the reference's rule), and is counted in
``failed_trials`` with its error in ``trial_errors``, so a kernel fault
cannot pass for a slow candidate unseen.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import (DEFAULT_TUNABLES, ModelConfig,
                                      ShapeSpec, Tunables)
from repro_torch.core.autonomic import AutonomicManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kermit import CallableExecutor, EventKind, KermitSession
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adamw import OptConfig, tree_leaves
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import (FailureInjector, SimulatedNodeFailure,
                                       StragglerDetector)
from repro_torch.runtime.telemetry import StepStats, TelemetryEmitter
from repro_torch.sharding import rules
from repro_torch.train.step import init_train_state, make_train_step


@dataclass
class RunReport:
    steps_done: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    failures_recovered: int = 0
    straggler_events: int = 0
    retunes: list = field(default_factory=list)
    analysis_events: int = 0
    final_tunables: Optional[dict] = None
    failed_trials: int = 0           # measured trials that raised


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 oc: OptConfig = OptConfig(),
                 tun: Tunables = DEFAULT_TUNABLES, *,
                 mesh=None, ckpt_dir: str | Path | None = None,
                 ckpt_every: int = 20,
                 autonomic: Optional[Union[KermitSession,
                                           AutonomicManager]] = None,
                 injector: Optional[FailureInjector] = None,
                 seed: int = 0, device=None):
        self.cfg, self.shape, self.oc = cfg, shape, oc
        self.tun = tun
        self.device = resolve_device(device)
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, "
                            f"not {type(mesh).__name__}")
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"mesh on {mesh.device}, Trainer on "
                             f"{self.device}")
        self.mesh = mesh
        rules.set_mesh(mesh)
        self.autonomic = autonomic.session \
            if isinstance(autonomic, AutonomicManager) else autonomic
        self.injector = injector
        self.straggler = StragglerDetector(device=self.device)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.seed = seed
        self.failed_trials = 0
        self.trial_errors: list = []

        self.state = self._init_state()
        self.pipeline = TokenPipeline(cfg, shape, seed=seed,
                                      prefetch=tun.prefetch,
                                      device=self.device)
        self.step_num = 0
        self._rebuild()
        n_active = sum(p.numel() for p in tree_leaves(self.state["params"]))
        self.telemetry = TelemetryEmitter(
            seq_len=shape.seq_len, global_batch=shape.global_batch,
            model_flops_per_step=6.0 * n_active * shape.seq_len *
            shape.global_batch,
            root=self.autonomic.db.root
            if self.autonomic and self.autonomic.db.root else None)

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return init_train_state(gen, self.cfg, self.oc, self.tun)

    def _rebuild(self):
        self._step = make_train_step(self.cfg, self.oc, self.tun,
                                     device=self.device)

    # -- objective for the Explorer (measured trial steps) ---------------------

    def measured_objective(self, repeats: int = 1):
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.pipeline._make(0).items()}

        def objective(tun: Tunables) -> float:
            if "ef" not in self.state and tun.grad_compression:
                tun = tun.replace(grad_compression=False)
            fn = make_train_step(self.cfg, self.oc, tun, device=self.device)
            try:
                fn(self.state, batch)                 # warm; result dropped
                _sync(self.device)
                ts = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    fn(self.state, batch)
                    _sync(self.device)
                    ts.append(time.perf_counter() - t0)
                return float(np.median(ts))
            except Exception as e:      # the reference's rule: cost inf
                self.failed_trials += 1
                self.trial_errors.append((tun.as_dict(), repr(e)))
                return float("inf")
        return objective

    # -- recovery ---------------------------------------------------------------

    def _recover(self):
        assert self.ckpt is not None, "failure without checkpointing enabled"
        # the live state is the template: same leaves, dtypes and device
        state, meta = self.ckpt.restore(self.state)
        if state is None:
            state = self._init_state()
            meta = {"step": 0, "pipeline": {"seed": self.seed, "step": 0}}
        self.state = state
        self.step_num = meta["step"]
        self.pipeline.close()
        self.pipeline = TokenPipeline.restore(self.cfg, self.shape,
                                              meta["pipeline"],
                                              prefetch=self.tun.prefetch,
                                              device=self.device)

    # -- main loop ----------------------------------------------------------------

    def run(self, steps: int) -> RunReport:
        rep = RunReport()
        failed0 = self.failed_trials
        unsubscribe = None
        if self.autonomic is not None:
            # Execute phase: measured trial steps of THIS trainer.  Rebind
            # when unset or owned by a previous Trainer run (schedules reuse
            # one session across phases with different model shapes).
            ex = self.autonomic.executor
            if ex is None or getattr(ex, "_trainer_owned", False):
                ex = CallableExecutor(self.measured_objective(
                    self.autonomic.config.execute.measure_repeats))
                ex._trainer_owned = True
                self.autonomic.bind_executor(ex, replace=True)

            def _on_analysis(ev, _rep=rep):
                _rep.analysis_events += 1
            unsubscribe = self.autonomic.subscribe(EventKind.ANALYSIS,
                                                   _on_analysis)
        try:
            return self._run_loop(steps, rep)
        finally:
            rep.failed_trials = self.failed_trials - failed0
            # sessions outlive Trainers (multi-phase schedules): the handler
            # must not leak into later phases even on an aborted run
            if unsubscribe is not None:
                unsubscribe()

    def _run_loop(self, steps: int, rep: RunReport) -> RunReport:
        # progress-based: failures + replays still land exactly on ``steps``
        while self.step_num < steps:
            try:
                if self.injector:
                    self.injector.check(self.step_num)
                batch = self.pipeline.next()
                t0 = time.perf_counter()
                self.state, metrics = self._step(self.state, batch)
                _sync(self.device)
                dt = time.perf_counter() - t0

                loss = float(metrics["loss"])
                rep.losses.append(loss)
                rep.step_times.append(dt)
                ev = self.straggler.observe(self.step_num, dt)
                if ev:
                    rep.straggler_events += 1

                sample = self.telemetry.emit(StepStats(
                    step_time=dt,
                    tokens=self.shape.seq_len * self.shape.global_batch,
                    loss=loss, grad_norm=float(metrics["grad_norm"]),
                    host_wait=self.pipeline.host_wait_s))

                if self.autonomic is not None:
                    new_tun = self.autonomic.step(sample)
                    if new_tun != self.tun:
                        if "ef" not in self.state:
                            new_tun = new_tun.replace(grad_compression=False)
                        self.tun = new_tun
                        rep.retunes.append((self.step_num,
                                            new_tun.as_dict()))
                        self._rebuild()

                self.step_num += 1
                rep.steps_done = self.step_num
                if self.ckpt and self.step_num % self.ckpt_every == 0:
                    self.ckpt.save(self.step_num, self.state, {
                        "pipeline": self.pipeline.state(),
                        "tunables": self.tun.as_dict()})
            except SimulatedNodeFailure:
                rep.failures_recovered += 1
                self._recover()
        rep.final_tunables = self.tun.as_dict()
        self.pipeline.close()
        return rep
