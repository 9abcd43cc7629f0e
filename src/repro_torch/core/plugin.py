"""KPlg — the KERMIT plug-in (paper Algorithm 1).

Port of ``repro/core/plugin.py`` (host-side Python; copied).  The
model-guided Plan path needs ``core/costmodel.py``, which is not ported
yet: ``model_guided=True`` raises when a search would take it (ROADMAP
queue A, "model-guided Plan").

Called at every resource request (here: before each training/serving step
bundle). Reads the latest workload context from the monitor stream, then:

  UNKNOWN label                -> default configuration J^D
  known + has optimal config   -> reuse stored configuration (no search!)
  known + drifting             -> Explorer.local_search from last good config
  known + no config            -> warm-started search: seed from the nearest
                                  stored WorkloadDB configuration by
                                  characterization distance (local refinement
                                  when statistically close, global from that
                                  start otherwise) — the paper's reuse story
                                  applied to search *initialization*, so a
                                  re-observed or ZSL-anticipated workload
                                  starts near its optimum; falls back to
                                  Explorer.global_search from J^D when the
                                  knowledge base holds no configuration yet

With ``model_guided`` on (PlanConfig.model_guided), the no-config branch
first tries the learned Plan path: a jitted cost model trained on the
record's stored ``SearchResult.trace`` rows ranks the grid, significance
analysis pins the knobs that don't matter, and the model's winner is only
committed after a real measurement confirms no regression vs the incumbent
— cold or mistrusted models fall back to the PR 4 batched searches (see
``core/costmodel.py`` and ``Explorer.model_ranked_exhaustive``).

Updates WorkloadDB with the result. Context staleness is measured in
*windows* — how far the stream has advanced past the context being acted on
— against ``max_staleness_windows``; stale contexts log an error and fall
back to default.  The window count comes from an injectable ``clock``
(defaulting to the monitor's own emitted-window counter), so staleness is
deterministic in tests and batch replays — the old wall-clock
``max_staleness_s`` guard is deprecated and ignored.
"""
from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.configs.base import DEFAULT_TUNABLES, Tunables
from repro_torch.core.explorer import Explorer
from repro_torch.core.knowledge import UNKNOWN, WorkloadDB
from repro_torch.core.monitor import KermitMonitor, WorkloadContext

log = logging.getLogger("kermit.plugin")

_UNSET = object()


def _executor_fault_types() -> tuple:
    """Exception types that mean "the executor faulted mid-measure" (vs a
    programming error, which must propagate).  The reference adds
    ``runtime.fault.SimulatedNodeFailure``, raised by the chaos executors,
    which arrive with ``runtime/fault.py`` in a later slice."""
    return (TimeoutError,)


@dataclass
class PluginStats:
    requests: int = 0
    default_used: int = 0
    reused: int = 0
    global_searches: int = 0
    local_searches: int = 0
    warm_starts: int = 0
    stale_contexts: int = 0
    failed_searches: int = 0
    evaluations: int = 0
    model_searches: int = 0      # committed through the model-guided path
    model_fallbacks: int = 0     # model cold/mistrusted -> PR 4 path


class KermitPlugin:
    def __init__(self, db: WorkloadDB, monitor: KermitMonitor,
                 explorer: Explorer | None = None,
                 default: Tunables = DEFAULT_TUNABLES,
                 max_staleness_windows: int = 256,
                 clock: Optional[Callable[[], int]] = None,
                 warm_start: bool = True,
                 model_guided: bool = False,
                 significance: float = 0.0,
                 regret_bound: float = 0.25,
                 min_trace: int = 32,
                 eval_budget: float = 0.10,
                 max_staleness_s: float = _UNSET):
        self.db = db
        self.monitor = monitor
        self.explorer = explorer or Explorer()
        self.default = default
        self.max_staleness_windows = max_staleness_windows
        self.clock = clock
        self.warm_start = warm_start
        # model-based Plan knobs (PlanConfig.model_guided et al.); the
        # learned path is opt-in — OFF reproduces the PR 4 searches
        # bit-identically
        self.model_guided = model_guided
        self.significance = significance
        self.regret_bound = regret_bound
        self.min_trace = min_trace
        self.eval_budget = eval_budget
        self._cost_model = None      # last trained CostModel (checkpointed)
        self._model_label = None     # workload it was trained for
        if max_staleness_s is not _UNSET:
            warnings.warn(
                "KermitPlugin(max_staleness_s=...) is deprecated and ignored "
                "— staleness is now window-count based; use "
                "max_staleness_windows (PlanConfig.max_staleness_windows)",
                DeprecationWarning, stacklevel=2)
        self.stats = PluginStats()
        self._memo_label = None     # workload the explorer memo belongs to

    def _window_now(self) -> int:
        """Current window count: injected clock or the monitor's counter."""
        if self.clock is not None:
            return int(self.clock())
        return self.monitor.windows_emitted

    def _snap_to_space(self, config: dict) -> Tunables:
        """Project a stored configuration onto the Explorer's search space:
        knobs whose stored value is not among the current candidates snap to
        the nearest candidate (numeric) or the first one (categorical).
        Without this, ``local_search`` from an off-grid start (a config
        stored under a different space) has an empty neighbour ring — it
        would commit the stale config as optimal after one evaluation and
        the reuse branch would lock onto it forever."""
        tun = Tunables(**config)
        kw = {}
        for knob, values in self.explorer.space.items():
            cur = getattr(tun, knob)
            if cur in values or not values:
                continue
            numeric = [v for v in values
                       if isinstance(v, (int, float))
                       and not isinstance(v, bool)]
            if numeric and isinstance(cur, (int, float)) \
                    and not isinstance(cur, bool):
                kw[knob] = min(numeric, key=lambda v: abs(v - cur))
            else:
                kw[knob] = values[0]
        return tun.replace(**kw) if kw else tun

    def on_resource_request(self, objective,
                            ctx: WorkloadContext | None = None) -> Tunables:
        """Algorithm 1. ``objective``: callable(Tunables) -> measured cost,
        evaluated only when a search actually runs.  ``ctx`` pins the request
        to a specific workload context (batch ingestion processes windows
        after the monitor has already moved on); defaults to the monitor's
        latest."""
        self.stats.requests += 1
        pinned = ctx is not None
        if ctx is None:
            ctx = self.monitor.latest_context()

        # staleness guards against a desynced monitor when *pulling* the
        # latest context; a pinned context is the right one by definition
        # (batch processing may reach it long after ingestion)
        if ctx is None or (not pinned and
                           (self._window_now() - 1 - ctx.window_id) >
                           self.max_staleness_windows):
            if ctx is not None:
                log.error("workload context stale (%d windows behind) — "
                          "using default; monitor out of sync",
                          self._window_now() - 1 - ctx.window_id)
            self.stats.stale_contexts += ctx is not None
            self.stats.default_used += 1
            return self.default

        label = ctx.current_label
        if label == UNKNOWN:
            self.stats.default_used += 1
            return self.default

        # a classifier trained before a Knowledge-phase merge may still
        # predict the absorbed label; the alias map keeps it resolvable
        label = self.db.resolve(label)
        rec = self.db.get(label)
        if rec is None:                       # classifier ahead of DB
            self.stats.default_used += 1
            return self.default

        if rec.has_optimal and rec.config is not None:
            self.stats.reused += 1
            return Tunables(**rec.config)

        # the memo holds costs measured under one workload; searching for a
        # different label (or re-searching after drift) must start clean
        if label != self._memo_label or rec.is_drifting:
            self.explorer.clear()
        self._memo_label = label

        try:
            res = self._search(objective, rec)
        except _executor_fault_types() as e:
            # a search died mid-plan on an executor fault the resilience
            # layer could not absorb; degrade to the best configuration the
            # knowledge base holds instead of crashing the loop.  Only
            # executor-fault types are caught — programming errors (e.g. the
            # unbound-executor RuntimeError) still propagate
            log.error("search failed on executor fault (%r) — falling back "
                      "to stored config", e)
            self.stats.failed_searches += 1
            if rec.config is not None:
                return Tunables(**rec.config)
            self.stats.default_used += 1
            return self.default
        self.stats.evaluations += res.evaluations
        self.db.set_config(label, res.best.as_dict(), optimal=True)
        # bank the measured evidence: future searches on this class train
        # the Plan cost model from it (harmless bookkeeping when the DB
        # lacks the surface, e.g. bare-dict test doubles)
        record_trace = getattr(self.db, "record_trace", None)
        if record_trace is not None and res.trace:
            record_trace(label, res.trace)
        self.db.save()
        return res.best

    def _search(self, objective, rec):
        """Pick + run the Algorithm-1 search branch for ``rec``."""
        if rec.is_drifting and rec.config is not None:
            res = self.explorer.local_search(
                objective, self._snap_to_space(rec.config))
            self.stats.local_searches += 1
            return res
        # warm start: a workload re-observed under a fresh label, or one
        # a ZSL hybrid anticipated, should not search from scratch —
        # seed from the nearest stored configuration instead.  The own
        # label is deliberately NOT excluded: reaching this branch means
        # rec has no optimal, but a stored non-optimal own config (a
        # distance-0 match) is the best possible start
        near = (self.db.nearest_config(rec.characterization)
                if self.warm_start else None)
        if self.model_guided:
            res = self._model_search(objective, rec, near)
            if res is not None:
                return res
            self.stats.model_fallbacks += 1
        if near is not None:
            warm_cfg, _, dist = near
            self.stats.warm_starts += 1
            if dist <= self.db.drift_eps:
                # statistically the same workload: its optimum is a
                # neighbour away at most — refine locally
                res = self.explorer.local_search(
                    objective, self._snap_to_space(warm_cfg))
                self.stats.local_searches += 1
            else:
                res = self.explorer.global_search(
                    objective, self._snap_to_space(warm_cfg))
                self.stats.global_searches += 1
        else:
            res = self.explorer.global_search(objective, self.default)
            self.stats.global_searches += 1
        return res

    def _model_search(self, objective, rec, near):
        """The learned Plan path of the reference (cost model trained on
        stored trace rows, significance pruning, safe commit).  It needs
        ``core/costmodel.py``, which is not ported yet."""
        raise NotImplementedError(
            "model-guided Plan needs core/costmodel.py, which is not ported "
            "yet (ROADMAP queue A: model-guided Plan)")
