"""KermitSupervisor — crash-recovery supervision for the MAPE-K loop.

Port of ``repro/kermit/supervisor.py``.  ``device`` (None: CUDA) is where
every session it boots or restores runs.  ``restart_on`` stays
``(SessionCrash,)``: any other exception, a CUDA error among them,
propagates to the caller instead of being replayed away.

The paper's autonomy claim ("without human intervention") has to survive the
manager itself dying, not just the managed system degrading.  This module
closes that gap with the classic supervised-process pattern:

  1. drive ``KermitSession.step_batch`` in checkpoint-stride chunks,
  2. ``session.checkpoint(path)`` after every chunk (crash-consistent —
     see ``runtime/checkpoint.py``'s atomic write protocol),
  3. on death (``SessionCrash`` from an injected ``CrashFault``, or any
     exception type listed in ``restart_on``), rebuild a fresh executor
     stack, ``KermitSession.restore`` the latest valid snapshot, disarm the
     crash fault up to the death window, and replay the gap.

Because every piece of decision-relevant state is in the snapshot (window
ring, Welch carry, trained models, Explorer memo, WorkloadDB, chaos clock +
fault journal, retry schedule, bounded event stream) and every stochastic
draw is keyed by counters inside that state, the replay is *bit-identical*:
a killed-and-restored run commits the same winners, logs the same labels,
and emits the same event stream (modulo its extra RESTORE events) as an
uninterrupted run — gated in ``tests/test_torch_durability.py`` and
``chip_smoke.py``'s ``durable_history``.

The supervisor never calls a human: recovery is bounded only by
``max_restores`` (default from ``ExecConfig``), after which the last death
propagates to the caller.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np

from repro_torch.kermit.chaos import SessionCrash
from repro_torch.kermit.config import KermitConfig
from repro_torch.kermit.executor import Executor
from repro_torch.kermit.session import KermitSession
from repro_torch.kernels.dispatch import resolve_device


class KermitSupervisor:
    """Supervise one session over one telemetry stream.

    ``executor_factory`` builds a *fresh* executor stack per (re)start —
    executors hold live resources and are never serialized; their journaled
    state is restored layer-by-layer from the snapshot instead
    (``KermitSession.restore(..., executor=)``).

    ``checkpoint_every`` (windows) and ``max_restores`` default to the
    config's ``execute`` subtree so manifests can declare durability policy
    alongside the rest of the loop.
    """

    def __init__(self, config: Optional[KermitConfig] = None,
                 executor_factory: Callable[[], Executor] = None, *,
                 checkpoint_path: str | Path,
                 checkpoint_every: Optional[int] = None,
                 max_restores: Optional[int] = None,
                 restart_on: tuple = (SessionCrash,),
                 device=None):
        if executor_factory is None:
            raise ValueError(
                "KermitSupervisor needs an executor_factory — a zero-arg "
                "callable building a fresh executor stack per (re)start")
        self.config = config or KermitConfig()
        self.executor_factory = executor_factory
        self.checkpoint_path = Path(checkpoint_path)
        ec = self.config.execute
        self.checkpoint_every = int(checkpoint_every
                                    if checkpoint_every is not None
                                    else ec.checkpoint_every)
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1 window")
        self.max_restores = int(max_restores if max_restores is not None
                                else ec.max_restores)
        self.restart_on = tuple(restart_on)
        self.device = resolve_device(device)
        self.session: Optional[KermitSession] = None
        self.restores = 0
        self.checkpoints = 0
        self.crashes = 0

    # -- internals -----------------------------------------------------------

    def _boot(self) -> KermitSession:
        """Fresh executor stack + session: restored from the latest snapshot
        when one exists, cold-started otherwise (death before the first
        checkpoint replays from the beginning)."""
        executor = self.executor_factory()
        if self.checkpoint_path.exists():
            return KermitSession.restore(self.checkpoint_path,
                                         executor=executor,
                                         device=self.device)
        return KermitSession(self.config, executor=executor,
                             device=self.device)

    @staticmethod
    def _ingested(session: KermitSession) -> int:
        """The session's position in the telemetry stream, in samples."""
        mon = session.monitor
        return mon.windows_emitted * mon.window_size + mon.pending_samples

    # -- the supervised loop -------------------------------------------------

    def run(self, samples=None) -> dict:
        """Drive the whole stream under supervision; returns a report dict
        (``restores`` / ``checkpoints`` / ``crashes`` / ``windows`` plus the
        final ``session.summary()``).  The surviving session is left on
        ``self.session`` for inspection."""
        session = KermitSession(self.config,
                                executor=self.executor_factory(),
                                device=self.device)
        if samples is None:
            samples = getattr(session.executor, "samples", None)
            if samples is None:
                raise ValueError(
                    "run() needs samples: none given and the executor "
                    "provides no telemetry stream")
        samples = np.asarray(samples, np.float32)
        stride = self.checkpoint_every * self.config.monitor.window_size

        while self._ingested(session) < len(samples):
            pos = self._ingested(session)
            take = stride - (pos % stride)
            chunk = samples[pos:pos + take]
            try:
                session.step_batch(chunk)
            except self.restart_on as e:
                self.crashes += 1
                if self.restores >= self.max_restores:
                    raise
                self.restores += 1
                session = self._boot()
                # the snapshot predates the crash fault's own done flag; an
                # armed crash would deterministically re-fire at the same
                # window, so disarm it up to the death window
                disarm = getattr(session.executor, "disarm", None)
                if callable(disarm):
                    disarm("crash", up_to=getattr(e, "window", None))
                continue
            session.checkpoint(self.checkpoint_path)
            self.checkpoints += 1

        self.session = session
        return {"restores": self.restores,
                "checkpoints": self.checkpoints,
                "crashes": self.crashes,
                "windows": session.monitor.windows_emitted,
                "summary": session.summary()}
