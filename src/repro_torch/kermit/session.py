"""KermitSession — the single entry point for the KERMIT MAPE-K loop.

Port of ``repro/kermit/session.py``.  ``KermitSession(config, executor=,
device=None)`` builds every phase on one device — CUDA unless the caller
passes ``device="cpu"``.  ``KermitConfig.impl`` picks the fast paths
(``"auto"``) or the seed paths end to end (``"legacy"``/``"seed"``: the
per-sample monitor, the seed analyser with the dense ``pairdist`` kernel,
the per-record WorkloadDB).  Durable sessions (``checkpoint``/``restore``)
write the reference's snapshot format: each package restores the other's.

Assembles the full loop (paper Fig. 3) from one declarative ``KermitConfig``
tree and closes it through a pluggable ``Executor``:

  Monitor    KermitMonitor ingests telemetry into observation windows
  Analyze    ChangeDetector on-line; KermitAnalyser batch discovery +
             retraining every ``analysis.interval`` windows
  Plan       KermitPlugin (Algorithm 1): reuse / local / global search
  Execute    the bound Executor — candidates are evaluated as
             ``apply(c); measure()`` and the committed winner is applied,
             so ``session.step(sample)`` needs no threaded objective
  Knowledge  WorkloadDB persists across runs

Telemetry sinks subscribe to the typed event stream instead of polling:

    session.subscribe(EventKind.RETUNE, on_retune, replay=16)

Event and context state is bounded (``max_events`` / monitor retention) so
long-running managed loops hold constant memory.
"""
from __future__ import annotations

from collections import deque
from dataclasses import asdict
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import DEFAULT_TUNABLES, Tunables
from repro_torch.core.analyser import KermitAnalyser
from repro_torch.core.change_detector import ChangeDetector
from repro_torch.core.explorer import Explorer
from repro_torch.core.forest import RandomForest
from repro_torch.core.knowledge import WorkloadDB
from repro_torch.core.lstm import WorkloadPredictor
from repro_torch.core.monitor import KermitMonitor, WorkloadContext
from repro_torch.core.plugin import KermitPlugin, PluginStats
from repro_torch.kermit.config import KermitConfig, resolve_impl
from repro_torch.kermit.events import AutonomicEvent, EventKind
from repro_torch.kermit.executor import Executor, ExecutorObjective
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.runtime import trace as T
from repro_torch.runtime.checkpoint import load_snapshot, save_snapshot

# -- durable-session snapshot schema ----------------------------------------

CHECKPOINT_FORMAT = "kermit-session"
CHECKPOINT_VERSION = 2
#   v2 adds the Plan-model state inside the "plugin" section: the trained
#   cost-model parameters + the label it was fitted for ("plan" subkey).
#   Per-record knob-sensitivity rankings travel inside the embedded
#   WorkloadDB state (its own v3 format).

# every top-level meta field version 2 defines; restore rejects snapshots
# carrying fields outside this set so a schema change can never be read
# silently as something else (mirrors WorkloadDB's versioned format)
_META_FIELDS = frozenset({
    "format", "version", "config", "session", "monitor", "models",
    "plugin", "knowledge", "executor",
})


def _migrate_v0(meta: dict) -> dict:
    """Forward-migrate a hypothetical pre-release v0 snapshot (no executor
    chain field) to v1.  Kept as the template for real future migrations —
    the same one-version-at-a-time chain WorkloadDB uses for its v1 -> v2
    database format."""
    meta = dict(meta)
    meta.setdefault("executor", [])
    meta["version"] = 1
    return meta


def _migrate_v1(meta: dict) -> dict:
    """v1 -> v2: the Plan phase gained a learned cost model; pre-model
    snapshots restore with an untrained one (the plugin's cold-model
    fallback covers the first post-restore searches)."""
    meta = dict(meta)
    plug = dict(meta.get("plugin") or {})
    plug.setdefault("plan", {"model": None, "label": None})
    meta["plugin"] = plug
    meta["version"] = 2
    return meta


_MIGRATIONS = {0: _migrate_v0, 1: _migrate_v1}


def _validate_checkpoint_meta(meta: dict) -> dict:
    """Schema-check + forward-migrate snapshot metadata, failing loudly (and
    naming the version) on anything this build cannot faithfully restore."""
    if meta.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(
            f"not a {CHECKPOINT_FORMAT} snapshot "
            f"(format={meta.get('format')!r})")
    version = int(meta.get("version", -1))
    if version > CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint version {version} is newer than the supported "
            f"version {CHECKPOINT_VERSION} — restore with a newer build")
    while version < CHECKPOINT_VERSION:
        migrate = _MIGRATIONS.get(version)
        if migrate is None:
            raise ValueError(
                f"checkpoint version {version} has no migration path to "
                f"version {CHECKPOINT_VERSION}")
        meta = migrate(meta)
        version = int(meta["version"])
    unknown = sorted(set(meta) - _META_FIELDS)
    if unknown:
        raise ValueError(
            f"checkpoint schema version {CHECKPOINT_VERSION} does not "
            f"define fields {unknown} — refusing a partial restore")
    return meta


class KermitSession:
    """``config`` declares the whole tree; ``executor`` closes the loop.
    ``detector``/``explorer`` accept pre-built component instances for tests
    and advanced callers — when omitted they are built from the config.
    ``device``: where the loop runs; None means CUDA."""

    def __init__(self, config: Optional[KermitConfig] = None, *,
                 executor: Optional[Executor] = None,
                 detector: Optional[ChangeDetector] = None,
                 explorer: Optional[Explorer] = None,
                 device=None):
        cfg = config or KermitConfig()
        self.config = cfg
        self.device = dev = resolve_device(device)
        fast_monitor, fast_analysis, dbscan_impl = resolve_impl(cfg.impl)
        if dbscan_impl in ("xla", "pallas_interpret") and dev.type == "cuda":
            raise ValueError(
                f"impl={cfg.impl!r} names a CPU kernel strategy; on the card "
                "the hand-written kernel is the only path (use 'auto')")

        mc, ac, pc, kc = cfg.monitor, cfg.analysis, cfg.plan, cfg.knowledge
        root = Path(kc.root) if kc.root else None
        self.db = WorkloadDB(root, drift_eps=kc.drift_eps, impl=cfg.impl,
                             drift_alpha=kc.drift_alpha,
                             merge_eps=kc.merge_eps,
                             max_records=kc.max_records, device=dev)
        det = detector or ChangeDetector(alpha=mc.detector_alpha,
                                         quorum=mc.detector_quorum,
                                         device=dev)
        self.monitor = KermitMonitor(
            window_size=mc.window_size, detector=det, root=root,
            fast=fast_monitor, retention=mc.retention,
            ctx_retention=mc.ctx_retention or mc.retention,
            ctx_flush_every=mc.ctx_flush_every, device=dev)
        self.analyser = KermitAnalyser(
            self.db, detector=det, dbscan_eps=ac.dbscan_eps,
            dbscan_min_pts=ac.dbscan_min_pts, max_classes=ac.max_classes,
            dbscan_impl=dbscan_impl, fast=fast_analysis, device=dev)
        default = Tunables(**pc.default_tunables) if pc.default_tunables \
            else DEFAULT_TUNABLES
        self.plugin = KermitPlugin(
            self.db, self.monitor,
            explorer or Explorer(pc.space, max_passes=pc.max_passes,
                                 max_memo=pc.max_memo,
                                 max_trace=pc.max_trace, chunk=pc.chunk),
            default, max_staleness_windows=pc.max_staleness_windows,
            clock=cfg.clock, warm_start=pc.warm_start,
            model_guided=pc.model_guided, significance=pc.significance,
            regret_bound=pc.regret_bound, min_trace=pc.min_trace,
            eval_budget=pc.eval_budget)

        self.executor = executor
        self._bind_chaos(executor)
        self.current = default
        self._last_label = None
        self._pending_fault: Optional[dict] = None
        self._since_analysis = 0
        self.events: deque[AutonomicEvent] = deque(maxlen=cfg.max_events)
        self.events_total = 0
        self._last_analysis_seconds: Optional[float] = None
        self._subscribers: list = []     # [(kind | None, fn)], insertion order

    # -- Execute binding -------------------------------------------------------

    def bind_executor(self, executor: Executor, *,
                      replace: bool = False) -> "KermitSession":
        """Attach (or with ``replace=True`` swap) the Execute-phase backend."""
        if self.executor is not None and not replace:
            raise RuntimeError(
                "session already has an executor; pass replace=True to swap")
        self.executor = executor
        self._bind_chaos(executor)
        return self

    def _bind_chaos(self, executor) -> None:
        """Chaos-aware executors keep fault time in *windows*; bind the
        monitor's emitted-window counter as their clock so fault activation
        tracks the managed stream this session actually ingests."""
        bind = getattr(executor, "bind_clock", None)
        if callable(bind):
            bind(lambda: self.monitor.windows_emitted)

    def _objective(self) -> Callable[[Tunables], float]:
        """The plan phase's candidate evaluator, bridged onto the executor.
        When ``plan.batch_eval`` is set and the executor implements the
        batched protocol, the bridge exposes ``batch``/``batch_arrays`` so
        the Explorer evaluates whole candidate sets per dispatch."""
        ex = self.executor
        if ex is None:
            def unbound(_t: Tunables) -> float:
                raise RuntimeError(
                    "KermitSession has no Executor bound — a configuration "
                    "search needs one to evaluate candidates; pass "
                    "executor= at construction or call bind_executor()")
            return unbound
        return ExecutorObjective(ex, batch=self.config.plan.batch_eval)

    # -- event subscription ----------------------------------------------------

    def subscribe(self, kind: EventKind | str | None,
                  fn: Callable[[AutonomicEvent], None], *,
                  replay: int = 0) -> Callable[[], None]:
        """Register ``fn`` for events of ``kind`` (None = all kinds).

        ``replay`` > 0 synchronously delivers up to that many of the most
        recent matching events from the bounded retained deque before any new
        ones — late-attaching sinks catch up without polling.  Returns an
        idempotent unsubscribe callable.  Handlers run synchronously on the
        ingesting thread; exceptions propagate to the caller of ``step``.
        """
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

    # -- the single integration point ------------------------------------------

    def step(self, sample) -> Tunables:
        """Feed one telemetry sample; returns the Tunables the managed system
        should run with (changes only at window boundaries)."""
        ctx = self.monitor.ingest(sample)
        if ctx is None:
            return self.current
        return self._on_context(ctx)

    def step_batch(self, samples) -> Tunables:
        """Feed a whole (N, F) telemetry batch.  Ingestion is chunked at
        analysis boundaries so classifier/predictor refreshes land exactly
        where a per-sample ``step`` loop would have placed them; within each
        chunk the monitor's fused fast path runs one device dispatch."""
        samples = np.asarray(samples, np.float32)
        W = self.monitor.window_size
        interval = self.config.analysis.interval
        i = 0
        while i < len(samples):
            win_left = max(interval - self._since_analysis, 1)
            need = max(win_left * W - self.monitor.pending_samples, 1)
            chunk = samples[i:i + need]
            i += len(chunk)
            for ctx in self.monitor.ingest_array(chunk):
                self._on_context(ctx)
        return self.current

    def run(self, samples=None) -> Tunables:
        """Drive the loop over ``samples``; defaults to the bound executor's
        own telemetry stream (e.g. SimulatorExecutor.samples)."""
        if samples is None:
            samples = getattr(self.executor, "samples", None)
            if samples is None:
                raise ValueError(
                    "run() needs samples: none given and the bound executor "
                    "provides no telemetry stream")
        return self.step_batch(samples)

    def run_live(self, stream) -> Tunables:
        """Drive the loop over a *live* window stream — an iterable yielding
        (N, F) sample arrays produced under the currently-applied
        configuration (e.g. ``ServeExecutor.telemetry_stream()``).  Unlike
        ``run``, the stream is pulled one batch at a time, so a retune
        committed mid-stream changes how every later batch is generated —
        the closed-loop shape for managed systems whose telemetry depends on
        the configuration the loop chooses."""
        with T.span("session.run_live", dropped=T.dropped):
            for samples in stream:
                self.step_batch(np.asarray(samples, np.float32))
        return self.current

    def invalidate(self) -> None:
        """Force a plan request at the next steady window — e.g. after an
        external reconfiguration invalidated the active choice."""
        self._last_label = None

    # -- per-window analyze/plan/execute ---------------------------------------

    def _on_context(self, ctx: WorkloadContext) -> Tunables:
        self._since_analysis += 1

        # chaos-aware executors journal fault activations; surface them as
        # typed FAULT events, and arm recovery tracking for persistent ones —
        # the forced re-plan below is the "without human intervention" path
        drain = getattr(self.executor, "drain_fault_events", None)
        if callable(drain):
            for fe in drain():
                self._record(AutonomicEvent(
                    ctx.window_id, EventKind.FAULT.value,
                    ctx.current_label, detail=dict(fe)))
                if fe.get("persistent"):
                    self._pending_fault = dict(fe)
                    self.invalidate()

        # off-line subsystem cadence (A of MAPE-K)
        ac = self.config.analysis
        if self._since_analysis >= ac.interval:
            self._since_analysis = 0
            ws = self.monitor.window_series()
            if ws is not None and len(ws) >= ac.min_windows:
                rep = self.analyser.run(
                    ws, synthesize_hybrids=ac.synthesize_hybrids,
                    zsl_k=ac.zsl_k)
                self.monitor.classifier = self.analyser.classifier
                self.monitor.predictor = self.analyser.predictor
                self._last_analysis_seconds = rep.analysis_seconds
                self._record(AutonomicEvent(
                    ctx.window_id, EventKind.ANALYSIS.value,
                    ctx.current_label,
                    detail={"clusters": rep.clusters,
                            "new": rep.new_labels,
                            "drifted": rep.drifted_labels,
                            "seconds": rep.analysis_seconds}))
                # Knowledge-phase adaptation events (drift / merge / evict)
                # journaled by the WorkloadDB during the run surface on the
                # typed stream; adaptation touching the active workload
                # forces a re-plan at the next steady window — the loop
                # re-tunes a drifted or merged class without any human call
                for je in self.db.drain_events():
                    self._record(AutonomicEvent(
                        ctx.window_id, EventKind(je["kind"]).value,
                        je["label"], detail=je["detail"]))
                    if self._last_label is not None and self._last_label in (
                            je["label"], je["detail"].get("absorbed")):
                        self.invalidate()

        # plan/execute at workload boundaries (label change or fresh optimum)
        label = ctx.current_label
        if ctx.in_transition:
            self._record(AutonomicEvent(
                ctx.window_id, EventKind.TRANSITION.value, label))
        if label != self._last_label and not ctx.in_transition:
            tun = self.plugin.on_resource_request(self._objective(), ctx=ctx)
            if tun != self.current:
                self._record(AutonomicEvent(
                    ctx.window_id, EventKind.RETUNE.value, label,
                    tunables=tun.as_dict()))
            # Execute: commit the planned winner after EVERY request — a
            # search evaluates candidates through the executor, so the
            # managed system may be left on the last candidate otherwise
            if self.executor is not None and \
                    self.config.execute.apply_on_retune:
                self.executor.apply(tun)
                # first re-plan after a persistent fault: measure the
                # committed configuration under the fault and journal the
                # throughput ratio vs the journaled pre-fault baseline
                if self._pending_fault is not None:
                    post = float(self.executor.measure())
                    pre = float(self._pending_fault.get(
                        "pre_fault_cost", post))
                    ratio = pre / post if post > 0 else 0.0
                    recovered = ratio >= \
                        self.config.execute.recovery_threshold
                    self._record(AutonomicEvent(
                        ctx.window_id, EventKind.RECOVERY.value, label,
                        tunables=tun.as_dict(),
                        detail={"fault": self._pending_fault.get("kind"),
                                "pre_fault_cost": pre, "post_cost": post,
                                "throughput_ratio": ratio,
                                "recovered": recovered}))
                    if recovered:
                        self._pending_fault = None
            self.current = tun
            self._last_label = label
        return self.current

    # -- knowledge persistence -------------------------------------------------

    def save_knowledge(self, path=None) -> None:
        """Persist the WorkloadDB (to ``knowledge.root`` or an explicit path)."""
        self.db.save(path)

    # -- durable session state (checkpoint / restore) --------------------------

    def _executor_chain(self) -> list:
        """The bound executor stack outermost-first, unwrapped through each
        layer's ``inner`` attribute.  Reads ``__dict__`` directly so the
        delegating ``__getattr__`` on chaos/resilient wrappers cannot forward
        the lookup past the layer being inspected."""
        chain = []
        ex = self.executor
        while ex is not None:
            chain.append(ex)
            ex = ex.__dict__.get("inner")
        return chain

    def _export_executor_state(self) -> list:
        """Per-layer ``(type, state)`` snapshot of the executor stack.  The
        ``export_state`` lookup is class-level for the same delegation
        reason as ``_executor_chain``."""
        out = []
        for ex in self._executor_chain():
            fn = getattr(type(ex), "export_state", None)
            out.append({"type": type(ex).__name__,
                        "state": fn(ex) if callable(fn) else None})
        return out

    def _restore_executor_state(self, saved: list) -> None:
        chain = self._executor_chain()
        if len(saved) != len(chain):
            raise ValueError(
                f"snapshot covers an executor stack of {len(saved)} layers "
                f"but the bound executor has {len(chain)} — rebuild the "
                "stack the snapshot was taken under before restoring")
        for entry, ex in zip(saved, chain):
            if entry["type"] != type(ex).__name__:
                raise ValueError(
                    f"snapshot executor layer {entry['type']!r} does not "
                    f"match bound layer {type(ex).__name__!r}")
            fn = getattr(type(ex), "restore_state", None)
            if entry.get("state") is not None and callable(fn):
                fn(ex, entry["state"])

    def checkpoint(self, path: str | Path) -> Path:
        """Atomically snapshot the entire MAPE-K state to one file.

        Covers every phase: Monitor (window ring, pending buffer, Welch
        carry, contexts), Analyze (trained forest/LSTM parameters via the
        ``runtime/checkpoint.py`` array serialization), Plan (Explorer memo +
        plugin stats), Knowledge (WorkloadDB in its versioned save format +
        undrained journal), Execute (per-layer executor state: chaos clock,
        fault journal, retry schedule, counters), plus the session's own
        scalars and bounded event stream.  The CHECKPOINT event is recorded
        *before* the write so the snapshot contains its own event — a
        restored run's stream stays bit-identical to an uninterrupted one.

        The write is crash-consistent (temp file + fsync + atomic rename):
        a crash mid-write leaves the previous snapshot intact."""
        path = Path(path)
        window = self.monitor.windows_emitted
        label = self._last_label if self._last_label is not None else -1
        self._record(AutonomicEvent(
            window, EventKind.CHECKPOINT.value, label,
            detail={"path": str(path), "window": window,
                    "version": CHECKPOINT_VERSION}))

        arrays: dict = {}
        mon_meta, mon_arr = self.monitor.export_state()
        arrays.update({f"monitor/{k}": v for k, v in mon_arr.items()})
        models: dict = {}
        for name in ("classifier", "transition_classifier", "predictor"):
            model = getattr(self.analyser, name)
            if model is None or getattr(model, "params", None) is None:
                models[name] = None
                continue
            m_meta, m_arr = model.state_dict()
            models[name] = m_meta
            arrays.update({f"{name}/{k}": v for k, v in m_arr.items()})

        meta = {
            "format": CHECKPOINT_FORMAT,
            "version": CHECKPOINT_VERSION,
            "config": self.config.to_dict(),
            "session": {
                "current": self.current.as_dict(),
                "last_label": self._last_label,
                "pending_fault": self._pending_fault,
                "since_analysis": self._since_analysis,
                "events_total": self.events_total,
                "last_analysis_seconds": self._last_analysis_seconds,
                "events": [asdict(e) for e in self.events],
            },
            "monitor": mon_meta,
            "models": models,
            "plugin": {"stats": vars(self.plugin.stats).copy(),
                       "memo_label": self.plugin._memo_label,
                       "memo": self.plugin.explorer.export_memo(),
                       "plan": {
                           "model": (self.plugin._cost_model.export_state()
                                     if self.plugin._cost_model is not None
                                     else None),
                           "label": self.plugin._model_label}},
            "knowledge": {"db": self.db.to_state(),
                          "journal": [dict(e) for e in self.db._journal]},
            "executor": self._export_executor_state(),
        }
        return save_snapshot(path, arrays, meta)

    @classmethod
    def restore(cls, path: str | Path, *,
                executor: Optional[Executor] = None,
                detector: Optional[ChangeDetector] = None,
                explorer: Optional[Explorer] = None,
                device=None) -> "KermitSession":
        """Rebuild a session from a ``checkpoint`` snapshot.

        ``executor`` supplies a freshly built executor stack (executors hold
        live resources and are never pickled); when its layer types match
        the snapshot's, each layer's journaled state — chaos clock, fault
        activation flags, retry schedule, measure counters — is restored so
        a replayed run perturbs and decides identically.  Validation is
        strict: unknown schema fields, missing migrations, and mismatched
        executor stacks all fail loudly rather than half-restore.
        ``device``: where the restored loop runs (None: CUDA); the trained
        models' arrays go onto it."""
        path = Path(path)
        arrays, meta = load_snapshot(path)
        meta = _validate_checkpoint_meta(meta)
        cfg = KermitConfig.from_dict(meta["config"])
        session = cls(cfg, executor=executor, detector=detector,
                      explorer=explorer, device=device)

        session.monitor.restore_state(
            meta["monitor"],
            {k[len("monitor/"):]: v for k, v in arrays.items()
             if k.startswith("monitor/")})

        model_types = {"classifier": RandomForest,
                       "transition_classifier": RandomForest,
                       "predictor": WorkloadPredictor}
        for name, model_cls in model_types.items():
            m_meta = meta["models"].get(name)
            if m_meta is None:
                continue
            prefix = name + "/"
            model = model_cls.from_state(
                m_meta, {k[len(prefix):]: v for k, v in arrays.items()
                         if k.startswith(prefix)}, device=session.device)
            setattr(session.analyser, name, model)
            if name in ("classifier", "predictor"):
                setattr(session.monitor, name, model)

        session.db.load_state(meta["knowledge"]["db"])
        session.db._journal = [dict(e)
                               for e in meta["knowledge"]["journal"]]

        plug = meta["plugin"]
        session.plugin.stats = PluginStats(**plug["stats"])
        session.plugin._memo_label = plug["memo_label"]
        session.plugin.explorer.restore_memo(plug["memo"])
        plan = plug.get("plan") or {}
        if plan.get("model") is not None:
            from repro_torch.core.costmodel import CostModel
            session.plugin._cost_model = CostModel.from_state(
                plan["model"], device=session.device)
            session.plugin._model_label = plan.get("label")

        s = meta["session"]
        session.current = Tunables(**s["current"])
        session._last_label = s["last_label"]
        session._pending_fault = (dict(s["pending_fault"])
                                  if s["pending_fault"] else None)
        session._since_analysis = int(s["since_analysis"])
        session._last_analysis_seconds = s["last_analysis_seconds"]
        for e in s["events"]:
            session.events.append(AutonomicEvent(**e))
        session.events_total = int(s["events_total"])

        if executor is not None:
            session._restore_executor_state(meta.get("executor") or [])

        window = session.monitor.windows_emitted
        session._record(AutonomicEvent(
            window, EventKind.RESTORE.value,
            session._last_label if session._last_label is not None else -1,
            detail={"path": str(path), "window": window,
                    "version": int(meta["version"])}))
        return session

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Flush + release the monitor's JSONL context stream."""
        self.monitor.close()

    def __enter__(self) -> "KermitSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reporting -------------------------------------------------------------

    def summary(self) -> dict:
        s = self.plugin.stats
        return {
            "impl": self.config.impl,
            "executor": type(self.executor).__name__ if self.executor
            else None,
            "last_analysis_seconds": self._last_analysis_seconds,
            "windows": self.monitor.windows_emitted,
            "known_workloads": len([r for r in self.db.records.values()
                                    if not r.is_synthetic]),
            "anticipated_hybrids": len([r for r in self.db.records.values()
                                        if r.is_synthetic]),
            "plugin": vars(s).copy(),
            "events": self.events_total,
            "events_retained": len(self.events),
            "pending_fault": self._pending_fault.get("kind")
            if self._pending_fault else None,
        }
