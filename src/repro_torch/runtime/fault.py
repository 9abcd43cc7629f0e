"""Fault tolerance: failure injection, straggler detection, elastic re-mesh.

Port of ``repro/runtime/fault.py``.  Any step can die: recovery is
restore-latest + replay (the data pipeline is counter-keyed, so replay is
exact).  Stragglers present as step-time distribution shifts, detected with
the same Welch machinery KERMIT uses for workload transitions.  Losing
nodes changes the mesh: ``elastic_restore`` reloads any checkpoint onto a
smaller or larger mesh, since checkpoints are stored unsharded and
resharding is a placement of each leaf.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.sharding import rules


class SimulatedNodeFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic failure schedule (fail at given step numbers) or
    probabilistic (rate per step, seeded — the same (seed, step) pair always
    draws the same outcome, so rate-mode runs replay exactly).

    Every fired failure is journaled (``journal`` entries carry the step and
    whether the scheduled or the rate path fired); ``fired`` is the
    inspectable set of steps that already failed.  A restored run passes the
    saved ``fired`` steps to ``reset`` so deterministic ``fail_steps`` that
    already fired before the crash do not fire again on replay.
    """
    fail_steps: tuple = ()
    rate: float = 0.0
    seed: int = 0
    _fired: set = field(default_factory=set)
    journal: list = field(default_factory=list)

    @property
    def fired(self) -> tuple:
        """Steps that have fired so far, ascending (replay-restorable)."""
        return tuple(sorted(self._fired))

    def reset(self, fired=()) -> None:
        """Clear the journal and mark ``fired`` steps as already fired —
        a restored run replays through them without re-raising."""
        self._fired = set(int(s) for s in fired)
        self.journal.clear()

    def _fire(self, step: int, mode: str) -> None:
        self._fired.add(step)
        self.journal.append({"step": step, "mode": mode})
        raise SimulatedNodeFailure(f"{mode} node failure at step {step}")

    def check(self, step: int):
        if step in self.fail_steps and step not in self._fired:
            self._fire(step, "scheduled")
        if self.rate > 0 and step not in self._fired:
            rng = np.random.default_rng((self.seed << 16) ^ step)
            if rng.random() < self.rate:
                self._fire(step, "rate")


class StragglerDetector:
    """Welch-based step-time shift detector (KERMIT ChangeDetector on the
    1-D step-time stream) + k×median spike rule for single-step stalls.

    Streaming state is bounded: ``times`` retains the most recent
    ``retention`` step times (enough for the 4×window median and the
    2×window Welch split) and ``events`` the most recent ``retention``
    detections.  ``device`` is the change detector's (None: CUDA).
    """

    def __init__(self, window: int = 16, spike_factor: float = 3.0,
                 alpha: float = 0.001, retention: int = 512, device=None):
        # deferred, as in the reference: core's plugin imports this module
        from repro_torch.core.change_detector import ChangeDetector
        if retention < 4 * window:
            raise ValueError(
                f"retention {retention} must cover 4*window={4 * window} "
                "step times (median + Welch history)")
        self.window = window
        self.spike = spike_factor
        self.det = ChangeDetector(alpha=alpha, quorum=1.0, device=device)
        self.times: deque[float] = deque(maxlen=retention)
        self.events: deque[dict] = deque(maxlen=retention)
        self.observed = 0            # step times ever seen (monotone)

    def observe(self, step: int, step_time: float) -> Optional[dict]:
        self.times.append(step_time)
        self.observed += 1
        ev = None
        n = self.window
        if len(self.times) >= 4:
            recent = list(self.times)[-4 * n:]
            med = float(np.median(recent))
            if step_time > self.spike * med:
                ev = {"step": step, "kind": "spike", "time": step_time,
                      "median": med}
        if ev is None and len(self.times) >= 2 * n:
            tail = list(self.times)[-2 * n:]
            a = np.asarray(tail[:n], np.float32)[:, None]
            b = np.asarray(tail[n:], np.float32)[:, None]
            if self.det.online((a.mean(0), a.var(0, ddof=1), n),
                               (b.mean(0), b.var(0, ddof=1), n)) \
                    and b.mean() > a.mean():
                ev = {"step": step, "kind": "sustained",
                      "before": float(a.mean()), "after": float(b.mean())}
        if ev:
            self.events.append(ev)
        return ev


def elastic_restore(ckpt_mgr, state_template, mesh, axes_tree):
    """Restore the latest checkpoint onto ``mesh`` (which may differ from
    the mesh that saved it); its tensors come back as DTensors placed by
    ``axes_tree``.  Returns (state, meta) or (None, None)."""
    rules.set_mesh(mesh)
    shardings = rules.tree_shardings(axes_tree) if mesh is not None else None
    return ckpt_mgr.restore(state_template, shardings=shardings)
