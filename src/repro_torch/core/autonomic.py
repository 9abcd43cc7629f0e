"""AutonomicManager — deprecated shim over ``repro_torch.kermit.KermitSession``.

Port of ``repro/core/autonomic.py``.  The assembled MAPE-K loop lives
behind the declarative config tree and the first-class Execute phase in
:mod:`repro_torch.kermit`; this module keeps the historical kwarg surface
working (with a ``DeprecationWarning``) and emits the same event streams
by delegating every decision to an embedded session.  ``device`` is the
session's (None means CUDA).

    # before                                   # now
    mgr = AutonomicManager(window_size=16)     cfg = KermitConfig(
    mgr.step(sample, objective)                    monitor=MonitorConfig(window_size=16))
                                               sess = KermitSession(cfg,
                                                   executor=CallableExecutor(objective))
                                               sess.step(sample)
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Callable, Optional

from repro_torch.configs.base import DEFAULT_TUNABLES, Tunables
from repro_torch.core.change_detector import ChangeDetector
from repro_torch.core.explorer import Explorer
from repro_torch.kermit.config import (AnalysisConfig, KermitConfig,
                                       KnowledgeConfig, MonitorConfig,
                                       PlanConfig)
from repro_torch.kermit.events import AutonomicEvent  # noqa: F401  (compat re-export)
from repro_torch.kermit.executor import CallableExecutor


class AutonomicManager:
    """Deprecated: use :class:`repro_torch.kermit.KermitSession`."""

    def __init__(self, *, root: str | Path | None = None,
                 window_size: int = 16,
                 analysis_interval: int = 24,
                 detector: Optional[ChangeDetector] = None,
                 explorer: Optional[Explorer] = None,
                 default: Tunables = DEFAULT_TUNABLES,
                 dbscan_eps: float = 0.35,
                 drift_eps: float = 1.0,
                 dbscan_impl: str = "auto",
                 fast_analysis: bool = True,
                 fast_monitor: bool = True,
                 monitor_retention: int = 4096,
                 max_events: int = 4096,
                 device=None):
        # deferred: kermit.session imports core submodules, so a top-level
        # import here would cycle through the repro_torch.core package init
        from repro_torch.kermit.session import KermitSession
        warnings.warn(
            "AutonomicManager is deprecated; build a KermitSession from a "
            "KermitConfig tree instead (see docs/api.md for the kwarg "
            "mapping)", DeprecationWarning, stacklevel=2)
        cfg = KermitConfig(
            monitor=MonitorConfig(window_size=window_size,
                                  retention=monitor_retention,
                                  ctx_retention=monitor_retention),
            analysis=AnalysisConfig(interval=analysis_interval,
                                    dbscan_eps=dbscan_eps),
            knowledge=KnowledgeConfig(root=str(root) if root else None,
                                      drift_eps=drift_eps),
            plan=PlanConfig(default_tunables=default.as_dict()
                            if default != DEFAULT_TUNABLES else None),
            max_events=max_events)
        self.session = KermitSession(cfg, detector=detector,
                                     explorer=explorer, device=device)
        # the unified impl policy is uniform by design; legacy mixed flags
        # (fast monitor + seed analysis, a pinned dbscan backend, ...) are
        # honoured by overriding the built components directly
        self.session.monitor.fast = fast_monitor
        self.session.analyser.fast = fast_analysis
        self.session.analyser.dbscan_impl = dbscan_impl if fast_analysis \
            else "legacy"

    # -- the single integration point -----------------------------------------

    def step(self, sample, objective: Callable[[Tunables], float]
             ) -> Tunables:
        """Feed one telemetry sample; the threaded ``objective`` is wrapped
        into a CallableExecutor (the Execute phase the session owns now)."""
        self._bind(objective)
        return self.session.step(sample)

    def step_batch(self, samples, objective: Callable[[Tunables], float]
                   ) -> Tunables:
        self._bind(objective)
        return self.session.step_batch(samples)

    def _bind(self, objective) -> None:
        ex = self.session.executor
        # == not `is`: per-step bound methods (mgr.step(s, self.objective))
        # compare equal, so the hot loop keeps one executor and its stats
        if isinstance(ex, CallableExecutor) and ex._objective == objective:
            return
        self.session.bind_executor(CallableExecutor(objective), replace=True)

    # -- delegated state --------------------------------------------------------

    @property
    def db(self):
        return self.session.db

    @property
    def monitor(self):
        return self.session.monitor

    @property
    def analyser(self):
        return self.session.analyser

    @property
    def plugin(self):
        return self.session.plugin

    @property
    def analysis_interval(self) -> int:
        return self.session.config.analysis.interval

    @property
    def current(self) -> Tunables:
        return self.session.current

    @current.setter
    def current(self, tun: Tunables) -> None:
        self.session.current = tun

    @property
    def events(self):
        return self.session.events

    @property
    def events_total(self) -> int:
        return self.session.events_total

    def _record(self, ev: AutonomicEvent) -> None:
        self.session._record(ev)

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        self.session.close()

    def __enter__(self) -> "AutonomicManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reporting -------------------------------------------------------------

    def summary(self) -> dict:
        return self.session.summary()
