"""KermitFleet — fleet-scale MAPE-K over S tenant sessions.

Port of ``repro/kermit/fleet.py``.  ``KermitFleet(config, executors=,
device=None)`` runs every phase on one device — CUDA unless the caller
passes ``device="cpu"``: the shared ``WorkloadDB``, the shared
``ChangeDetector``, every tenant's analyser and the stacked cohort
parameters all live there.

A provider runs the autonomic loop not for one managed system but for a
fleet of them, each with its own workload stream, knowledge namespace and
committed configuration.  Run as S independent ``KermitSession``s the
Monitor phase alone costs S monitor steps plus S Python round-trips per
window tick; the fleet collapses that to one step per cohort:

  Monitor    per-tenant window state lives in ONE ``BatchedWindowRing``
             (a leading tenant axis over mean/var/label slots) and every
             fleet tick runs ONE ``fleet_monitor_step`` per cohort — a
             ``torch.func.vmap`` of the very same ``_monitor_step`` each
             scalar monitor runs, so per-tenant transition flags, labels
             and predictions equal S scalar monitors'.  Its launches per
             tick do not grow with S.  A cohort's inputs reach the device
             in two copies from pinned staging buffers and its three
             results come back with one synchronisation.
  Analyse/   stay per-tenant: each tick a numpy work queue selects only the
  Plan       tenants that need a Python-side decision (transition seen,
             label changed, analysis due, or a chaos executor to drain) and
             ``_process`` mirrors ``KermitSession._on_context`` for them
  Knowledge  ONE shared ``WorkloadDB``.  Records are tenant-tagged and each
             tenant sees only its own namespace through a ``TenantDBView``
             (local labels 0,1,2,... exactly as a private DB would assign),
             but ``nearest_config`` warm-start lookups are tenant-agnostic:
             a class discovered and tuned by tenant A warm-starts tenant
             B's search — the cross-tenant transfer the shared store buys.
             ``FleetStats.fleet_evals_saved`` counts the evaluations those
             transfers avoided vs the donor's own cold search.

Tenants advance in lockstep (every tick ingests one window per tenant), so
the ring head, history length and Welch ``has_prev`` are shared scalars —
the vmapped step needs no per-tenant control flow.  Tenants whose trained
classifier/predictor shapes differ (e.g. different class counts) dispatch
as separate cohorts, rebuilt only when an analysis refreshes models.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import DEFAULT_TUNABLES, Tunables
from repro_torch.core.analyser import KermitAnalyser
from repro_torch.core.change_detector import ChangeDetector
from repro_torch.core.explorer import Explorer
from repro_torch.core.knowledge import UNKNOWN, WorkloadDB
from repro_torch.core.lstm import HORIZONS
from repro_torch.core.monitor import (FASTPATH_STATS, WorkloadContext,
                                      fleet_monitor_step)
from repro_torch.core.plugin import KermitPlugin
from repro_torch.core.windows import BatchedWindowRing
from repro_torch.kermit.config import KermitConfig, resolve_impl
from repro_torch.kermit.events import AutonomicEvent, EventKind
from repro_torch.kermit.executor import Executor, ExecutorObjective
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.optim.adamw import tree_map

# per-tenant "no label committed yet" sentinel: real labels are >= -1
# (UNKNOWN), so the int64 minimum can never collide
_NO_LABEL = np.iinfo(np.int64).min


def _cohort_bucket(n: int) -> int:
    """Power-of-two cohort padding, so the shapes the vmapped step sees are
    bounded in cohort-size variants (mirrors the monitor's _BUCKETS)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _tree_key(tree, prefix: str = "") -> tuple:
    """(key path, shape, dtype) of every tensor of a params dict, in sorted
    key order: tenants with equal keys stack into one cohort."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.extend(_tree_key(v, path))
        else:
            out.append((path, tuple(v.shape), str(v.dtype)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Knowledge: per-tenant namespace over the shared store
# ---------------------------------------------------------------------------


class TenantDBView:
    """One tenant's view of the shared ``WorkloadDB``.

    Presents exactly the surface ``KermitAnalyser`` and ``KermitPlugin``
    consume from a private DB — local labels are allocated 0,1,2,... in
    insert order, so every label a tenant's analyser, classifier or event
    stream sees is bit-identical to what an isolated session's private DB
    would have assigned.  Underneath, records live tenant-tagged in the
    shared store: ``find_match``/``consolidate`` are tenant-scoped (one
    tenant's classes never match or merge with another's) while
    ``nearest_config`` ranks ALL tenants' stored configurations when
    ``transfer`` is on — the fleet's cross-tenant warm-start path.  A
    foreign donor is reported via ``last_foreign_donor`` (its *global*
    label) so the fleet can account the transfer.
    """

    def __init__(self, db: WorkloadDB, tenant: int, *,
                 max_records: int, transfer: bool = True):
        self.db = db
        self.tenant = int(tenant)
        self.max_records = int(max_records)   # per-tenant record bound
        self.transfer = transfer
        self._l2g: dict[int, int] = {}        # local label -> global label
        self._g2l: dict[int, int] = {}
        self._next_local = 0
        # per-plan-request transfer bookkeeping (reset by the fleet)
        self.last_foreign_donor: Optional[int] = None
        self.last_set_config: Optional[int] = None

    # -- namespace plumbing --------------------------------------------------

    def _bind(self, local: int, global_label: int) -> None:
        self._l2g[local] = global_label
        self._g2l[global_label] = local

    @property
    def device(self) -> torch.device:
        return self.db.device

    @property
    def drift_eps(self) -> float:
        return self.db.drift_eps

    @property
    def _next_label(self) -> int:
        # the analyser passes this to the ZSL synthesizer as the first free
        # label; local allocation order matches a private DB's counter
        return self._next_local

    @property
    def records(self) -> dict:
        """{local label: live shared record} — membership and iteration
        order (ascending local label) match a private DB."""
        out = {}
        for l, g in self._l2g.items():
            rec = self.db.records.get(g)
            if rec is not None:
                out[l] = rec
        return out

    def labels(self):
        return sorted(self.records)

    def resolve(self, label: int) -> int:
        g = self._l2g.get(label)
        if g is None:
            return label
        return self._g2l.get(self.db.resolve(g), label)

    def get(self, label: int):
        g = self._l2g.get(label)
        return None if g is None else self.db.get(g)

    # -- core operations (the analyser/plugin surface) -----------------------

    def find_match(self, char: dict) -> Optional[int]:
        g = self.db.find_match(char, tenant=self.tenant)
        return None if g is None else self._g2l[g]

    def observe(self, label: int, char: dict) -> bool:
        return self.db.observe(self._l2g[label], char)

    def insert(self, char: dict, *, is_synthetic: bool = False, pair=None,
               label: int | None = None) -> int:
        gpair = None
        if pair is not None:
            # local->global is strictly increasing per tenant, so a sorted
            # local combo stays sorted — but canonicalize anyway
            gpair = tuple(sorted(self._l2g[p] for p in pair))
        if label is None:
            local = self._next_local
            self._next_local += 1
            g = self.db.insert(char, is_synthetic=is_synthetic, pair=gpair,
                               tenant=self.tenant)
            self._bind(local, g)
            return local
        local = int(label)
        self._next_local = max(self._next_local, local + 1)
        g = self._l2g.get(local)
        if g is None:
            g = self.db.insert(char, is_synthetic=is_synthetic, pair=gpair,
                               tenant=self.tenant)
            self._bind(local, g)
        else:
            # re-insert under an existing local label replaces the record,
            # exactly like WorkloadDB.insert(label=...)
            self.db.insert(char, is_synthetic=is_synthetic, pair=gpair,
                           label=g, tenant=self.tenant)
        return local

    def set_config(self, label: int, config: dict, optimal: bool) -> None:
        g = self._l2g[label]
        self.db.set_config(g, config, optimal)
        self.last_set_config = self.db.resolve(g)

    def nearest_config(self, char: dict, *,
                       exclude_label: int | None = None) -> Optional[tuple]:
        g_ex = None if exclude_label is None \
            else self._l2g.get(exclude_label)
        res = self.db.nearest_config(
            char, exclude_label=g_ex,
            tenant=None if self.transfer else self.tenant)
        if res is None:
            return None
        cfg, g, dist = res
        rec = self.db.records.get(self.db.resolve(g))
        if rec is not None and rec.tenant is not None \
                and rec.tenant != self.tenant:
            # cross-tenant donor: surface its global label for transfer
            # accounting; the plugin only consumes (config, distance)
            self.last_foreign_donor = g
            return cfg, g, dist
        return cfg, self._g2l.get(g, g), dist

    def _donor_global(self, label: int) -> int:
        """Resolve a label the plugin got back from ``nearest_config``:
        a cross-tenant donor surfaces its *global* label (reported via
        ``last_foreign_donor``), anything else is local."""
        if label == self.last_foreign_donor:
            return label
        g = self._l2g.get(label)
        return label if g is None else g

    def record_trace(self, label: int, rows) -> None:
        self.db.record_trace(self._l2g[label], rows)

    def get_trace(self, label: int) -> list:
        """Stored trace rows; accepts a foreign donor's global label, so
        warm-transfer donors ship their measurement evidence (and hence
        sensitivity rankings) across tenants."""
        return self.db.get_trace(self._donor_global(label))

    def set_sensitivity(self, label: int, sens: dict) -> None:
        self.db.set_sensitivity(self._l2g[label], sens)

    def get_sensitivity(self, label: int) -> Optional[dict]:
        return self.db.get_sensitivity(self._donor_global(label))

    def find_synthetic(self, combo: tuple) -> Optional[int]:
        try:
            gcombo = tuple(sorted(self._l2g[c] for c in combo))
        except KeyError:
            return None
        g = self.db.find_synthetic(gcombo)
        return None if g is None else self._g2l.get(g)

    def refresh_synthetic(self, label: int, prototype: dict) -> None:
        self.db.refresh_synthetic(self._l2g[label], prototype)

    def pure_characterizations(self) -> dict:
        return {l: r.characterization for l, r in self.records.items()
                if not r.is_synthetic}

    def consolidate(self) -> list:
        return self.db.consolidate(tenant=self.tenant)

    def drain_events(self) -> list[dict]:
        """Claim this tenant's entries from the shared adaptation journal
        (translated to local labels); other tenants' entries stay queued."""
        mine, rest = [], []
        for je in self.db._journal:
            local = self._g2l.get(je.get("label"))
            if local is None:
                rest.append(je)
                continue
            je = dict(je, label=local)
            detail = je.get("detail") or {}
            if "absorbed" in detail:
                detail = dict(detail)
                detail["absorbed"] = self._g2l.get(detail["absorbed"],
                                                   detail["absorbed"])
                je["detail"] = detail
            mine.append(je)
        self.db._journal = rest
        return mine

    def save(self, path=None) -> None:
        self.db.save(path)


# ---------------------------------------------------------------------------
# Monitor: the per-tenant shim over the batched ring
# ---------------------------------------------------------------------------


class _TenantMonitorView:
    """What ``KermitPlugin`` (and the analyser hand-off) expect from a
    monitor, backed by the fleet's shared batched state.  Holds the
    tenant's trained classifier/predictor references — the fleet regroups
    dispatch cohorts from these after every analysis refresh."""

    def __init__(self, fleet: "KermitFleet", tenant: int):
        self._fleet = fleet
        self._tenant = tenant
        self.classifier = None
        self.predictor = None

    @property
    def window_size(self) -> int:
        return self._fleet.config.base.monitor.window_size

    @property
    def windows_emitted(self) -> int:
        ring = self._fleet.ring
        return 0 if ring is None else ring.total

    @property
    def pending_samples(self) -> int:
        return self._fleet.pending_samples

    def window_series(self, copy: bool = False):
        ring = self._fleet.ring
        if ring is None or len(ring) == 0:
            return None
        return ring.series(self._tenant, copy)

    def latest_context(self) -> Optional[WorkloadContext]:
        return self._fleet._latest_context(self._tenant)


@dataclass
class _TenantState:
    """Everything per-tenant the lockstep loop threads through a tick."""
    index: int
    db: TenantDBView
    monitor: _TenantMonitorView
    analyser: KermitAnalyser
    plugin: KermitPlugin
    executor: Optional[Executor]
    current: Tunables
    pending_fault: Optional[dict] = None


@dataclass
class _Cohort:
    """One vmapped-step group: tenants whose model params share keys,
    shapes and dtypes, padded to a power-of-two bucket."""
    idx: np.ndarray            # true tenant rows (unpadded)
    pad_idx: np.ndarray        # bucket-padded tenant rows
    clf_stack: object          # stacked forest params | None
    pred_stack: object         # stacked predictor params | None
    depth: int
    pw: int                    # predictor window (1 = no predictor)
    pcl: int                   # predictor class count
    stage_f: torch.Tensor      # (4, bucket, F) f32 host staging: mean,
    #                            var, previous mean, previous var
    stage_h: torch.Tensor      # (bucket, pw - 1) int32 label histories


# ---------------------------------------------------------------------------
# Config + stats
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FleetConfig:
    """Declarative fleet spec: how many tenants, the per-tenant MAPE-K tree
    they all run (``base``), and whether the shared knowledge base performs
    cross-tenant warm-start transfer.  The shared store's record bound is
    ``base.knowledge.max_records`` *per tenant* (scaled by ``tenants``)."""
    tenants: int = 8
    base: KermitConfig = field(default_factory=KermitConfig)
    transfer: bool = True

    def to_dict(self) -> dict:
        return {"tenants": self.tenants, "transfer": self.transfer,
                "base": self.base.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "FleetConfig":
        unknown = sorted(set(d) - {"tenants", "transfer", "base"})
        if unknown:
            raise ValueError(f"unknown FleetConfig keys: {unknown}")
        return cls(tenants=int(d.get("tenants", 8)),
                   transfer=bool(d.get("transfer", True)),
                   base=KermitConfig.from_dict(d.get("base", {})))


@dataclass
class FleetStats:
    ticks: int = 0             # lockstep fleet ticks (one window per tenant)
    dispatches: int = 0        # vmapped monitor steps run (ticks x cohorts)
    traces: int = 0            # the reference's XLA compilations; the port
    #                            compiles nothing, so it stays 0
    analyses: int = 0          # per-tenant Analyse-phase runs
    plans: int = 0             # per-tenant Plan-phase requests
    warm_transfers: int = 0    # searches warm-started from a foreign tenant
    fleet_evals_saved: int = 0  # evaluations avoided vs the donors' own
    #                             cold searches (the transfer win)


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------


class KermitFleet:
    """S lockstep MAPE-K loops with a one-step-per-cohort Monitor phase and
    a shared, tenant-namespaced Knowledge base.

    ``executors`` closes each tenant's loop: a sequence of S executors, a
    factory ``tenant index -> Executor``, or None (searches then require no
    evaluation, exactly like an executor-less ``KermitSession``).
    ``device``: where the loop runs; None means CUDA.

    Feed telemetry with ``ingest(samples)`` where ``samples`` is (S, N, F)
    — N raw samples per tenant, buffered across calls until whole windows
    complete — or ``run()`` to drive the loop over the executors' own
    streams.  Per-tenant decisions (labels, transition flags, committed
    winners) equal S isolated ``KermitSession``s fed the same traces.
    """

    def __init__(self, config: Optional[FleetConfig] = None, *,
                 executors=None, device=None):
        fc = config or FleetConfig()
        self.config = fc
        base = fc.base
        S = int(fc.tenants)
        if S < 1:
            raise ValueError("KermitFleet needs at least one tenant")
        fast_monitor, fast_analysis, dbscan_impl = resolve_impl(base.impl)
        if not fast_monitor:
            raise ValueError(
                f"KermitFleet requires the batched monitor path; "
                f"impl={base.impl!r} resolves to the legacy per-window loop")
        self.device = dev = resolve_device(device)
        if dbscan_impl in ("xla", "pallas_interpret") and dev.type == "cuda":
            raise ValueError(
                f"impl={base.impl!r} names a CPU kernel strategy; on the card "
                "the hand-written kernel is the only path (use 'auto')")

        mc, ac, pc, kc = (base.monitor, base.analysis, base.plan,
                          base.knowledge)
        root = Path(kc.root) if kc.root else None
        # ONE shared store for the whole fleet; the per-tenant bound the
        # analyser enforces is kc.max_records, so the global bound scales
        self.db = WorkloadDB(root, drift_eps=kc.drift_eps, impl=base.impl,
                             drift_alpha=kc.drift_alpha,
                             merge_eps=kc.merge_eps,
                             max_records=kc.max_records * S, device=dev)
        self.detector = ChangeDetector(alpha=mc.detector_alpha,
                                       quorum=mc.detector_quorum, device=dev)
        default = Tunables(**pc.default_tunables) if pc.default_tunables \
            else DEFAULT_TUNABLES
        self.default = default

        self._tenants: list[_TenantState] = []
        for t in range(S):
            if executors is None:
                ex = None
            elif callable(executors):
                ex = executors(t)
            else:
                ex = executors[t]
            view = TenantDBView(self.db, t, max_records=kc.max_records,
                                transfer=fc.transfer)
            mview = _TenantMonitorView(self, t)
            analyser = KermitAnalyser(
                view, detector=self.detector, dbscan_eps=ac.dbscan_eps,
                dbscan_min_pts=ac.dbscan_min_pts, max_classes=ac.max_classes,
                dbscan_impl=dbscan_impl, fast=fast_analysis, device=dev)
            plugin = KermitPlugin(
                view, mview,
                Explorer(pc.space, max_passes=pc.max_passes,
                         max_memo=pc.max_memo, max_trace=pc.max_trace,
                         chunk=pc.chunk),
                default, max_staleness_windows=pc.max_staleness_windows,
                clock=base.clock, warm_start=pc.warm_start,
                model_guided=pc.model_guided, significance=pc.significance,
                regret_bound=pc.regret_bound, min_trace=pc.min_trace,
                eval_budget=pc.eval_budget)
            bind = getattr(ex, "bind_clock", None)
            if callable(bind):
                bind(lambda: 0 if self.ring is None else self.ring.total)
            self._tenants.append(_TenantState(
                index=t, db=view, monitor=mview, analyser=analyser,
                plugin=plugin, executor=ex, current=default))
        self._drain_idx = [t.index for t in self._tenants
                           if callable(getattr(t.executor,
                                               "drain_fault_events", None))]

        self.ring: Optional[BatchedWindowRing] = None   # width-lazy
        self._pending: Optional[np.ndarray] = None      # (S, r, F) remainder
        self._cohorts: Optional[list[_Cohort]] = None   # None -> rebuild
        self._last_label = np.full(S, _NO_LABEL, np.int64)
        self._since_analysis = 0
        self._last_ctx = None          # (wid, labels, trans, preds, mean)
        self._evals_spent: dict[int, int] = {}  # global label -> search cost
        self.stats = FleetStats()
        self.events: deque[AutonomicEvent] = deque(maxlen=base.max_events)
        self.events_total = 0
        self._subscribers: list = []

    # -- event stream (mirrors KermitSession.subscribe) ----------------------

    def subscribe(self, kind, fn: Callable[[AutonomicEvent], None], *,
                  replay: int = 0) -> Callable[[], None]:
        kind = None if kind is None else str(EventKind(kind))
        entry = (kind, fn)
        if replay > 0:
            matching = [e for e in self.events
                        if kind is None or e.kind == kind]
            for ev in matching[-replay:]:
                fn(ev)
        self._subscribers.append(entry)

        def unsubscribe() -> None:
            try:
                self._subscribers.remove(entry)
            except ValueError:
                pass
        return unsubscribe

    def _record(self, ev: AutonomicEvent) -> None:
        self.events.append(ev)
        self.events_total += 1
        for kind, fn in tuple(self._subscribers):
            if kind is None or ev.kind == kind:
                fn(ev)

    # -- plumbing -------------------------------------------------------------

    @property
    def tenants(self) -> int:
        return len(self._tenants)

    @property
    def pending_samples(self) -> int:
        return 0 if self._pending is None else int(self._pending.shape[1])

    @property
    def current(self) -> list[Tunables]:
        """Per-tenant committed configuration."""
        return [t.current for t in self._tenants]

    def plugin_stats(self, tenant: int):
        return self._tenants[tenant].plugin.stats

    def tenant_db(self, tenant: int) -> TenantDBView:
        return self._tenants[tenant].db

    def invalidate(self, tenant: int) -> None:
        """Force a plan request at the tenant's next steady window."""
        self._last_label[tenant] = _NO_LABEL

    def _objective(self, tenant: int):
        ex = self._tenants[tenant].executor
        if ex is None:
            def unbound(_t: Tunables) -> float:
                raise RuntimeError(
                    f"fleet tenant {tenant} has no Executor bound — a "
                    "configuration search needs one to evaluate candidates")
            return unbound
        return ExecutorObjective(ex, batch=self.config.base.plan.batch_eval)

    def _latest_context(self, tenant: int) -> Optional[WorkloadContext]:
        if self._last_ctx is None:
            return None
        wid, labels, trans, preds, mean = self._last_ctx
        return self._make_ctx(tenant, wid, int(labels[tenant]),
                              bool(trans[tenant]), preds[:, tenant],
                              mean[tenant])

    @staticmethod
    def _make_ctx(tenant, wid, label, in_trans, pred_row, feat_row):
        return WorkloadContext(
            window_id=wid, timestamp=time.time(), current_label=label,
            predicted={h: int(pred_row[i]) for i, h in enumerate(HORIZONS)},
            in_transition=in_trans,
            features=[float(x) for x in feat_row])

    # -- cohort grouping ------------------------------------------------------

    def _build_cohorts(self) -> list[_Cohort]:
        groups: dict = {}
        for t, ten in enumerate(self._tenants):
            clf = ten.monitor.classifier
            pred = ten.monitor.predictor
            if clf is not None and (getattr(clf, "params", None) is None
                                    or not hasattr(clf, "fc")):
                raise TypeError(
                    "KermitFleet monitors require trained RandomForest "
                    "classifiers (duck-typed classifiers have no tensor "
                    "params to stack)")
            if pred is not None and getattr(pred, "params", None) is None:
                pred = None
            ckey = None
            if clf is not None:
                ckey = (clf.fc.depth, _tree_key(clf.params))
            pkey = None
            if pred is not None:
                pkey = (int(pred.pc.window), int(pred.pc.n_classes),
                        _tree_key(pred.params))
            groups.setdefault((ckey, pkey), []).append(t)

        pin = self.device.type == "cuda"
        F = self.ring.mean.shape[2]
        cohorts = []
        for (ckey, pkey), ts in groups.items():
            idx = np.asarray(ts, np.int64)
            bucket = _cohort_bucket(len(ts))
            pad_idx = np.concatenate(
                [idx, np.full(bucket - len(ts), ts[-1], np.int64)])

            def stack(*xs):
                return torch.stack(xs)
            clf_stack = None
            depth = 0
            if ckey is not None:
                depth = ckey[0]
                clf_stack = tree_map(
                    stack, *[self._tenants[i].monitor.classifier.params
                             for i in pad_idx])
            pred_stack = None
            pw, pcl = 1, 1
            if pkey is not None:
                pw, pcl = pkey[0], pkey[1]
                if pw > self.ring.capacity:
                    raise ValueError(
                        f"predictor window {pw} exceeds fleet retention "
                        f"{self.ring.capacity}")
                pred_stack = tree_map(
                    stack, *[self._tenants[i].monitor.predictor.params
                             for i in pad_idx])
            cohorts.append(_Cohort(
                idx=idx, pad_idx=pad_idx, clf_stack=clf_stack,
                pred_stack=pred_stack, depth=depth, pw=pw, pcl=pcl,
                stage_f=torch.empty((4, bucket, F), dtype=torch.float32,
                                    pin_memory=pin),
                stage_h=torch.empty((bucket, pw - 1), dtype=torch.int32,
                                    pin_memory=pin)))
        return cohorts

    # -- ingestion ------------------------------------------------------------

    def ingest(self, samples) -> list[Tunables]:
        """Feed an (S, N, F) telemetry block — N raw samples per tenant.
        Partial windows buffer across calls; every completed window advances
        the whole fleet one lockstep tick."""
        samples = np.asarray(samples, np.float32)
        S = self.tenants
        if samples.ndim != 3 or samples.shape[0] != S:
            raise ValueError(
                f"fleet ingest expects (tenants={S}, N, F) samples, "
                f"got shape {samples.shape}")
        if self._pending is not None:
            samples = np.concatenate([self._pending, samples], axis=1)
            self._pending = None
        W = self.config.base.monitor.window_size
        T = samples.shape[1] // W
        if samples.shape[1] > T * W:
            self._pending = samples[:, T * W:].copy()
        if T == 0:
            return self.current
        buf = samples[:, :T * W]
        # identical arithmetic to make_windows / the scalar monitor's
        # windowing, tenant-parallel: (S, T, W, F) -> per-window mean/var
        wm = buf.reshape(S, T, W, -1).mean(2)
        wv = buf.reshape(S, T, W, -1).var(2, ddof=1)
        for k in range(T):
            self._tick(wm[:, k], wv[:, k])
        return self.current

    def run(self, traces=None) -> list[Tunables]:
        """Drive the loop over per-tenant traces; defaults to the bound
        executors' own telemetry streams.  ``traces`` may be an (S, N, F)
        array or a sequence of S equal-length (N, F) arrays."""
        if traces is None:
            traces = [getattr(t.executor, "samples", None)
                      for t in self._tenants]
            if any(tr is None for tr in traces):
                raise ValueError(
                    "run() needs traces: at least one tenant executor "
                    "provides no telemetry stream")
        if not isinstance(traces, np.ndarray):
            lens = {len(tr) for tr in traces}
            if len(lens) != 1:
                raise ValueError(
                    f"lockstep fleet needs equal-length tenant traces, got "
                    f"lengths {sorted(lens)}")
            traces = np.stack([np.asarray(tr, np.float32) for tr in traces])
        return self.ingest(traces)

    # -- the lockstep tick ----------------------------------------------------

    def _step(self, co: _Cohort, mean, var, pm, pv, has_prev: bool, hist,
              log_len: int, mask) -> tuple:
        """One cohort's vmapped monitor step: its inputs written into the
        cohort's staging buffers and copied to the device in two
        transfers, its three results copied back with one
        synchronisation.  Returns numpy (trans, labels, preds)."""
        dev = self.device
        pidx = co.pad_idx
        f = co.stage_f.numpy()
        f[0], f[1], f[2], f[3] = mean[pidx], var[pidx], pm[pidx], pv[pidx]
        co.stage_h.numpy()[:] = hist[pidx]
        nb = dev.type == "cuda"
        df = co.stage_f.to(dev, non_blocking=nb)
        dh = co.stage_h.to(dev, non_blocking=nb)
        W = self.config.base.monitor.window_size
        det = self.detector
        out = fleet_monitor_step(
            df[0][:, None], df[1][:, None], df[2], df[3], has_prev, dh,
            log_len, co.clf_stack, co.pred_stack, mask, n=W,
            alpha=det.alpha, quorum=det.quorum, depth=co.depth,
            pred_window=co.pw, pred_classes=co.pcl)
        host = [o.to("cpu", non_blocking=nb) for o in out]
        if nb:
            torch.cuda.current_stream(dev).synchronize()
        return tuple(h.numpy() for h in host)

    def _tick(self, mean: np.ndarray, var: np.ndarray) -> None:
        S = self.tenants
        if self.ring is None:
            mc = self.config.base.monitor
            self.ring = BatchedWindowRing(S, mc.retention, mean.shape[1],
                                          mc.window_size)
        ring = self.ring
        if self._cohorts is None:
            self._cohorts = self._build_cohorts()

        mask = self.detector._mask()
        if ring.total:
            pm, pv = ring.last_window()
            has_prev = True
        else:
            pm = np.zeros_like(mean)
            pv = pm
            has_prev = False

        labels = np.full(S, UNKNOWN, np.int32)
        trans = np.zeros(S, bool)
        preds = np.full((len(HORIZONS), S), UNKNOWN, np.int32)
        for co in self._cohorts:
            n_true = len(co.idx)
            hist = ring.last_labels(co.pw - 1)
            FASTPATH_STATS["dispatches"] += 1
            self.stats.dispatches += 1
            tr, lb, pr = self._step(co, mean, var, pm, pv, has_prev, hist,
                                    ring.total, mask)
            trans[co.idx] = tr[:n_true, 0]
            labels[co.idx] = lb[:n_true, 0]
            preds[:, co.idx] = pr[:n_true, :, 0].T

        ring.push_tick(mean, var, labels)
        wid = ring.total - 1
        self.stats.ticks += 1
        self._last_ctx = (wid, labels, trans, preds, mean)

        # work queue: only tenants that need a Python-side decision
        self._since_analysis += 1
        analysis_due = self._since_analysis >= \
            self.config.base.analysis.interval
        if analysis_due:
            self._since_analysis = 0
        need = trans | (labels.astype(np.int64) != self._last_label)
        if analysis_due:
            need[:] = True
        for t in self._drain_idx:
            need[t] = True
        for t in np.flatnonzero(need):
            self._process(int(t), wid, int(labels[t]), bool(trans[t]),
                          preds[:, t], mean[t], analysis_due)

    # -- the per-tenant slow path (mirrors KermitSession._on_context) --------

    def _process(self, t: int, wid: int, label: int, in_trans: bool,
                 pred_row, feat_row, analysis_due: bool) -> None:
        ten = self._tenants[t]
        base = self.config.base

        # chaos-aware executors journal fault activations
        drain = getattr(ten.executor, "drain_fault_events", None)
        if callable(drain):
            for fe in drain():
                self._record(AutonomicEvent(
                    wid, EventKind.FAULT.value, label, detail=dict(fe),
                    tenant=t))
                if fe.get("persistent"):
                    ten.pending_fault = dict(fe)
                    self.invalidate(t)

        # Analyse cadence — the fleet keeps ONE lockstep counter, so every
        # tenant's analysis lands on the same ticks an isolated session's
        # per-session counter would pick
        ac = base.analysis
        if analysis_due:
            ws = ten.monitor.window_series()
            if ws is not None and len(ws) >= ac.min_windows:
                rep = ten.analyser.run(
                    ws, synthesize_hybrids=ac.synthesize_hybrids,
                    zsl_k=ac.zsl_k)
                ten.monitor.classifier = ten.analyser.classifier
                ten.monitor.predictor = ten.analyser.predictor
                self._cohorts = None        # models changed: regroup
                self.stats.analyses += 1
                self._record(AutonomicEvent(
                    wid, EventKind.ANALYSIS.value, label,
                    detail={"clusters": rep.clusters,
                            "new": rep.new_labels,
                            "drifted": rep.drifted_labels,
                            "seconds": rep.analysis_seconds}, tenant=t))
                last = self._last_label[t]
                for je in ten.db.drain_events():
                    self._record(AutonomicEvent(
                        wid, EventKind(je["kind"]).value, je["label"],
                        detail=je["detail"], tenant=t))
                    if last != _NO_LABEL and last in (
                            je["label"], je["detail"].get("absorbed")):
                        self.invalidate(t)

        if in_trans:
            self._record(AutonomicEvent(
                wid, EventKind.TRANSITION.value, label, tenant=t))
        if label != self._last_label[t] and not in_trans:
            ctx = self._make_ctx(t, wid, label, in_trans, pred_row, feat_row)
            view = ten.db
            view.last_foreign_donor = None
            view.last_set_config = None
            before = ten.plugin.stats.evaluations
            tun = ten.plugin.on_resource_request(self._objective(t), ctx=ctx)
            spent = ten.plugin.stats.evaluations - before
            self.stats.plans += 1
            if spent > 0:
                # remember what each class's own (first) search cost, keyed
                # by global label — future cross-tenant warm starts compare
                # against the donor's recorded cost
                g = view.last_set_config
                if g is not None and g not in self._evals_spent:
                    self._evals_spent[g] = spent
                donor = view.last_foreign_donor
                if donor is not None:
                    self.stats.warm_transfers += 1
                    donor_cost = self._evals_spent.get(
                        self.db.resolve(donor))
                    if donor_cost:
                        self.stats.fleet_evals_saved += max(
                            donor_cost - spent, 0)
            if tun != ten.current:
                self._record(AutonomicEvent(
                    wid, EventKind.RETUNE.value, label,
                    tunables=tun.as_dict(), tenant=t))
            if ten.executor is not None and base.execute.apply_on_retune:
                ten.executor.apply(tun)
                if ten.pending_fault is not None:
                    post = float(ten.executor.measure())
                    pre = float(ten.pending_fault.get(
                        "pre_fault_cost", post))
                    ratio = pre / post if post > 0 else 0.0
                    recovered = ratio >= base.execute.recovery_threshold
                    self._record(AutonomicEvent(
                        wid, EventKind.RECOVERY.value, label,
                        tunables=tun.as_dict(),
                        detail={"fault": ten.pending_fault.get("kind"),
                                "pre_fault_cost": pre, "post_cost": post,
                                "throughput_ratio": ratio,
                                "recovered": recovered}, tenant=t))
                    if recovered:
                        ten.pending_fault = None
            ten.current = tun
            self._last_label[t] = label

    # -- reporting ------------------------------------------------------------

    def summary(self) -> dict:
        plug = {}
        for ten in self._tenants:
            for k, v in vars(ten.plugin.stats).items():
                plug[k] = plug.get(k, 0) + v
        return {
            "tenants": self.tenants,
            "impl": self.config.base.impl,
            "transfer": self.config.transfer,
            "windows": 0 if self.ring is None else
            self.ring.total * self.tenants,
            "known_workloads": len([r for r in self.db.records.values()
                                    if not r.is_synthetic]),
            "anticipated_hybrids": len([r for r in self.db.records.values()
                                        if r.is_synthetic]),
            "plugin": plug,
            "stats": vars(self.stats).copy(),
            "events": self.events_total,
        }
