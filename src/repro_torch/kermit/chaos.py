"""Chaos layer for the Execute boundary — seeded fault injection + resilience.

Port of ``repro/kermit/chaos.py`` (host-side Python; copied).  Every draw is
a counter-keyed ``np.random.default_rng`` call, the reference's own, so
fault and retry schedules are bit-identical across the two packages.
``ResilientExecutor.retry_on`` keeps the reference's executor-fault types
(``SimulatedNodeFailure``, ``TimeoutError``): a CUDA error or an
out-of-memory is not a fault to price away, and propagates.

The paper's headline claim is autonomy, not just speed: KERMIT "can identify
and learn new workload classes, and adapt to workload drift, without human
intervention".  This module makes that claim testable under fault conditions
the paper never ran, by wrapping any ``Executor``/``BatchExecutor`` in two
composable layers:

``ChaosExecutor``
    Injects faults on a seeded, window-indexed schedule (declared as
    ``FaultSpec`` dataclasses, JSON-round-trippable for the scenario
    manifest):

      StragglerFault   persistent multiplicative slowdown of every measure;
                       configurations matching the fault's ``mitigation``
                       knobs see only ``mitigated_factor`` (a slow node
                       taxes synchronous collectives; e.g. gradient
                       compression shrinks the exposure), and the managed
                       telemetry stream shifts (``telemetry_delta``) so the
                       Monitor's Welch detector sees the straggler as a
                       workload transition — the ``runtime/fault.py``
                       framing, closed through the whole MAPE-K loop
      TransientFaults  ``SimulatedNodeFailure`` raised from measures on a
                       replayable ``FailureInjector`` schedule/rate
      NoiseFault       seeded lognormal measurement noise
      StuckKnobFault   the managed system silently ignores one knob —
                       ``apply`` pins it, batched probes price the pinned
                       value, so the search can't be fooled by configs the
                       system will never actually run

    Fault activations are journaled; ``KermitSession`` drains the journal
    (``drain_fault_events``) into typed ``FAULT`` events and, for persistent
    faults, tracks recovery: the first re-plan after the fault measures the
    committed configuration and emits a ``RECOVERY`` event with the
    throughput ratio vs the journaled pre-fault baseline.

``ResilientExecutor``
    Bounded retry-with-backoff plus timeout fallback around any executor, so
    transient failures degrade the Plan phase gracefully instead of crashing
    it mid-search.  With zero injected faults it is a bit-transparent
    pass-through (identical winners, costs and evaluation counts — gated in
    ``tests/test_torch_chaos.py``).

Fault time is measured in *windows* of the managed telemetry stream: the
session binds its monitor's emitted-window counter as the chaos clock
(``bind_clock``), so fault activation, the telemetry shift, and the loop's
own notion of time all agree deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.configs.base import (DEFAULT_TUNABLES, Tunables,
                                      encode_tunable_values)
from repro_torch.runtime.fault import FailureInjector, SimulatedNodeFailure

# default straggler telemetry signature (feature-name -> additive shift of
# the normalized telemetry mean): step time and collective/stall fractions
# up, throughput down — far enough from any archetype (L2 ~0.65, 5/16
# features shifted) that Welch flags a transition and DBSCAN discovers a
# distinct class at the default eps/quorum thresholds
STRAGGLER_TELEMETRY_DELTA = {
    "step_time": 0.45,
    "tokens_per_s": -0.20,
    "coll_frac": 0.25,
    "host_wait": 0.15,
    "expert_imbalance": 0.30,
}


@dataclass
class FaultSpec:
    """Base fault: activates once the chaos clock reaches ``at_window`` and
    stays active for ``duration`` windows (None = persistent)."""
    at_window: int = 0
    duration: Optional[int] = None

    kind = "fault"
    expects_recovery = False         # persistent degradations gate recovery

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


@dataclass
class StragglerFault(FaultSpec):
    """Persistent slow node: every measure costs ``factor``× unless the
    candidate matches the ``mitigation`` knob values (then
    ``mitigated_factor``×); the telemetry stream shifts by
    ``telemetry_delta`` from ``at_window`` on."""
    factor: float = 3.0
    mitigation: dict = field(
        default_factory=lambda: {"grad_compression": True})
    mitigated_factor: float = 1.08
    telemetry_delta: dict = field(
        default_factory=lambda: dict(STRAGGLER_TELEMETRY_DELTA))

    kind = "straggler"
    expects_recovery = True

    def factor_for(self, tunables: Tunables) -> float:
        if all(getattr(tunables, k) == v for k, v in self.mitigation.items()):
            return self.mitigated_factor
        return self.factor


@dataclass
class TransientFaults(FaultSpec):
    """Transient ``SimulatedNodeFailure`` on a replayable schedule: explicit
    ``fail_steps`` (measure-call indices) and/or a seeded per-measure
    ``rate`` (see ``runtime.fault.FailureInjector``)."""
    fail_steps: tuple = ()
    rate: float = 0.0

    kind = "transient"


@dataclass
class NoiseFault(FaultSpec):
    """Seeded lognormal measurement noise of sigma ``scale`` — identical
    seeds replay identical noise."""
    scale: float = 0.05

    kind = "noise"


@dataclass
class StuckKnobFault(FaultSpec):
    """The managed system ignores one knob: every applied configuration and
    every batched probe runs with ``knob`` pinned to ``value``."""
    knob: str = "microbatches"
    value: object = 1

    kind = "stuck_knob"
    expects_recovery = True


class SessionCrash(RuntimeError):
    """The KERMIT manager process died (a ``CrashFault`` fired, or a real
    exception a supervisor chose to treat as death).  ``window`` is the chaos
    clock at the time of death — the supervisor disarms crash faults up to it
    after restore so a deterministic replay does not re-die."""

    def __init__(self, message: str, *, window: Optional[int] = None):
        super().__init__(message)
        self.window = window


@dataclass
class CrashFault(FaultSpec):
    """Manager-side death: once the chaos clock reaches ``at_window`` the
    next fault sync raises ``SessionCrash`` — the session loop (not the
    managed system) dies mid-run.  Recovery is the supervisor's job
    (restore-latest + replay), not the Plan phase's, so
    ``expects_recovery`` stays False and no telemetry shifts."""

    kind = "crash"


_FAULT_KINDS = {cls.kind: cls for cls in
                (StragglerFault, TransientFaults, NoiseFault, StuckKnobFault,
                 CrashFault)}


def fault_from_dict(d: dict) -> FaultSpec:
    """Manifest JSON -> FaultSpec (the scenario runner's decoder)."""
    d = dict(d)
    kind = d.pop("kind", None)
    cls = _FAULT_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"choose from {sorted(_FAULT_KINDS)}")
    if "fail_steps" in d:
        d["fail_steps"] = tuple(d["fail_steps"])
    return cls(**d)


class ChaosExecutor:
    """Fault-injecting wrapper around any ``Executor``/``BatchExecutor``.

    Forwards the full batched protocol of ``inner`` (hiding the parts inner
    does not implement, per the ``ExecutorObjective`` probing idiom) and
    perturbs results according to the active faults.  With no faults it is
    transparent: identical costs, identical counters (counters delegate to
    ``inner``).  ``seed`` makes every stochastic fault replayable.

    The chaos clock defaults to a manual counter (``advance``); sessions
    bind their monitor's emitted-window counter via ``bind_clock`` so fault
    activation tracks the managed stream.  ``drain_fault_events`` hands the
    activation journal to the session, which emits typed FAULT events — the
    entry for a persistent fault carries ``pre_fault_cost``, the inner
    (fault-free) cost of the currently applied configuration, the baseline
    the session's RECOVERY event measures against.
    """

    def __init__(self, inner, faults: Sequence[FaultSpec] = (), *,
                 seed: int = 0, window_size: Optional[int] = None,
                 clock: Optional[Callable[[], int]] = None,
                 max_journal: int = 1024):
        self.inner = inner
        self.faults = list(faults)
        self.seed = int(seed)
        self._clock = clock
        self._manual_window = 0
        self._active = [False] * len(self.faults)
        self._done = [False] * len(self.faults)
        self._journal: deque = deque(maxlen=max_journal)
        self._measure_calls = 0
        self.injected: dict[str, int] = {}
        self._injectors = {
            i: FailureInjector(fail_steps=tuple(f.fail_steps), rate=f.rate,
                               seed=self.seed + i)
            for i, f in enumerate(self.faults)
            if isinstance(f, TransientFaults)}
        self.current: Tunables = getattr(inner, "current", DEFAULT_TUNABLES)
        if window_size is None:
            result = getattr(inner, "result", None)
            window_size = getattr(result, "window_size", 32)
        self.window_size = int(window_size)
        # hide protocol surface the inner executor does not implement
        if not callable(getattr(inner, "measure_batch", None)):
            self.measure_batch = None
        if not callable(getattr(inner, "measure_batch_arrays", None)):
            self.measure_batch_arrays = None

    # -- chaos clock ---------------------------------------------------------

    def bind_clock(self, clock: Callable[[], int]) -> None:
        """Bind the managed stream's window counter as the fault clock."""
        self._clock = clock

    def advance(self, n_windows: int = 1) -> None:
        """Manually advance the clock (tests / sessionless use)."""
        self._manual_window += int(n_windows)

    def _now(self) -> int:
        return int(self._clock()) if self._clock is not None \
            else self._manual_window

    # -- fault state ---------------------------------------------------------

    def _sync(self) -> None:
        now = self._now()
        for i, f in enumerate(self.faults):
            if not self._active[i] and not self._done[i] \
                    and now >= f.at_window:
                if isinstance(f, CrashFault):
                    # mark done *before* raising: the dying process must not
                    # re-crash while unwinding, and a restored run disarms
                    # the fault explicitly (its snapshot predates this flag)
                    self._done[i] = True
                    self.injected[f.kind] = self.injected.get(f.kind, 0) + 1
                    raise SessionCrash(
                        f"injected manager crash at window {now} "
                        f"(scheduled at {f.at_window})", window=now)
                self._active[i] = True
                self.injected[f.kind] = self.injected.get(f.kind, 0) + 1
                entry = {"kind": f.kind, "window": now,
                         "at_window": f.at_window,
                         "persistent": f.expects_recovery,
                         "fault": f.to_dict()}
                if f.expects_recovery:
                    entry["pre_fault_cost"] = self._clean_cost(self.current)
                self._journal.append(entry)
            if self._active[i] and f.duration is not None \
                    and now >= f.at_window + f.duration:
                self._active[i] = False
                self._done[i] = True
                self._journal.append({"kind": f.kind, "window": now,
                                      "cleared": True, "persistent": False})

    def _clean_cost(self, tunables: Tunables) -> float:
        """Fault-free cost of ``tunables`` on the inner executor (a probe —
        the applied configuration is not moved when inner supports batches)."""
        mb = getattr(self.inner, "measure_batch", None)
        if callable(mb):
            return float(mb([tunables])[0])
        restore = getattr(self.inner, "current", None)
        self.inner.apply(tunables)
        cost = float(self.inner.measure())
        if restore is not None:
            self.inner.apply(restore)
        return cost

    def active_faults(self) -> list:
        self._sync()
        return [f for i, f in enumerate(self.faults) if self._active[i]]

    def drain_fault_events(self) -> list:
        """Hand the activation journal to the caller (KermitSession turns
        entries into typed FAULT events) and clear it."""
        self._sync()
        out = list(self._journal)
        self._journal.clear()
        return out

    def disarm(self, kind: str, *, up_to: Optional[int] = None) -> int:
        """Mark pending faults of ``kind`` as already done (not firing).
        ``up_to`` bounds it to faults scheduled at or before that window —
        the supervisor disarms ``crash`` faults up to the death window after
        a restore, since the restored snapshot predates the fault's own
        done flag and an armed crash would re-fire deterministically."""
        n = 0
        for i, f in enumerate(self.faults):
            if f.kind == kind and not self._done[i] \
                    and (up_to is None or f.at_window <= up_to):
                self._active[i] = False
                self._done[i] = True
                n += 1
        return n

    # -- durable-session state (see KermitSession.checkpoint) ---------------

    def export_state(self) -> dict:
        """JSON-able snapshot of the chaos clock + fault state: activation
        flags, the undrained journal, the measure-call counter that keys
        noise/transient draws, and each injector's fired set — everything a
        replayed run needs to perturb identically."""
        return {"manual_window": self._manual_window,
                "active": list(self._active), "done": list(self._done),
                "measure_calls": self._measure_calls,
                "injected": dict(self.injected),
                "journal": [dict(e) for e in self._journal],
                "current": self.current.as_dict(),
                "fired": {str(i): list(inj.fired)
                          for i, inj in self._injectors.items()}}

    def restore_state(self, state: dict) -> None:
        if len(state["active"]) != len(self.faults):
            raise ValueError(
                f"chaos snapshot covers {len(state['active'])} faults but "
                f"this executor declares {len(self.faults)} — rebuild the "
                "stack with the fault schedule the snapshot was taken under")
        self._manual_window = int(state["manual_window"])
        self._active = [bool(b) for b in state["active"]]
        self._done = [bool(b) for b in state["done"]]
        self._measure_calls = int(state["measure_calls"])
        self.injected = {str(k): int(v) for k, v in state["injected"].items()}
        self._journal = deque((dict(e) for e in state["journal"]),
                              maxlen=self._journal.maxlen)
        self.current = Tunables(**state["current"])
        for key, fired in state.get("fired", {}).items():
            inj = self._injectors.get(int(key))
            if inj is not None:
                inj.reset(fired=fired)

    # -- per-fault perturbations --------------------------------------------

    def _stuck(self, tunables: Tunables) -> Tunables:
        kw = {f.knob: f.value for i, f in enumerate(self.faults)
              if self._active[i] and isinstance(f, StuckKnobFault)}
        return tunables.replace(**kw) if kw else tunables

    def _straggler_factor(self, tunables: Tunables) -> float:
        factor = 1.0
        for i, f in enumerate(self.faults):
            if self._active[i] and isinstance(f, StragglerFault):
                factor *= f.factor_for(tunables)
        return factor

    def _noise(self, n: int, step: int) -> Optional[np.ndarray]:
        mult = None
        for i, f in enumerate(self.faults):
            if self._active[i] and isinstance(f, NoiseFault):
                rng = np.random.default_rng((self.seed << 20) ^ (step + i))
                draw = rng.lognormal(0.0, f.scale, size=n)
                mult = draw if mult is None else mult * draw
        return mult

    def _transient_check(self, step: int) -> None:
        now = self._now()
        for i, inj in self._injectors.items():
            if not self._active[i]:
                continue
            try:
                inj.check(step)
            except SimulatedNodeFailure:
                self._journal.append({"kind": "transient", "window": now,
                                      "step": step, "persistent": False})
                raise

    def _next_step(self) -> int:
        step = self._measure_calls
        self._measure_calls += 1
        return step

    # -- Executor protocol ---------------------------------------------------

    def apply(self, tunables: Tunables) -> None:
        self._sync()
        eff = self._stuck(tunables)
        self.current = eff
        self.inner.apply(eff)

    def measure(self) -> float:
        self._sync()
        step = self._next_step()
        self._transient_check(step)
        cost = float(self.inner.measure())
        cost *= self._straggler_factor(self.current)
        mult = self._noise(1, step)
        if mult is not None:
            cost *= float(mult[0])
        return cost

    def measure_batch(self, candidates: Sequence[Tunables]) -> list:
        self._sync()
        step = self._next_step()
        self._transient_check(step)
        cands = [self._stuck(c) for c in candidates]
        base = self.inner.measure_batch(cands)
        costs = [float(b) * self._straggler_factor(c)
                 for b, c in zip(base, cands)]
        mult = self._noise(len(costs), step)
        if mult is not None:
            costs = [c * float(m) for c, m in zip(costs, mult)]
        return costs

    def measure_batch_arrays(self, arrays: dict) -> np.ndarray:
        self._sync()
        step = self._next_step()
        self._transient_check(step)
        arrays = dict(arrays)
        n = len(np.reshape(next(iter(arrays.values())), (-1,)))
        for i, f in enumerate(self.faults):
            if self._active[i] and isinstance(f, StuckKnobFault):
                pin = encode_tunable_values(f.knob, [f.value])
                arrays[f.knob] = np.broadcast_to(pin[0], (n,))
        costs = np.asarray(self.inner.measure_batch_arrays(arrays),
                           np.float64).reshape(-1).copy()
        for i, f in enumerate(self.faults):
            if self._active[i] and isinstance(f, StragglerFault):
                match = np.ones((n,), bool)
                for k, v in f.mitigation.items():
                    col = np.asarray(arrays[k]).reshape(-1)
                    match &= col == encode_tunable_values(k, [v])[0]
                costs *= np.where(match, f.mitigated_factor, f.factor)
        mult = self._noise(n, step)
        if mult is not None:
            costs *= mult
        return costs

    # -- managed telemetry ---------------------------------------------------

    @property
    def samples(self) -> np.ndarray:
        """The inner executor's telemetry stream with every scheduled
        telemetry perturbation rendered in (stragglers shift their window
        span), so ``session.run(chaos.samples)`` sees the fault exactly when
        the chaos clock activates it."""
        from repro_torch.core.simulator import inject_feature_shift
        samples = np.array(getattr(self.inner, "samples"), np.float32)
        for f in self.faults:
            delta = getattr(f, "telemetry_delta", None)
            if delta:
                samples = inject_feature_shift(
                    samples, self.window_size, f.at_window, delta,
                    duration=f.duration)
        return samples

    # -- delegated counter surface ------------------------------------------

    def __getattr__(self, name):
        # counters (applied/measured/...), `result`, and any other inner
        # surface delegate transparently; only chaos state lives here
        return getattr(self.inner, name)


class ResilientExecutor:
    """Bounded retry-with-backoff + timeout fallback around any executor.

    ``measure``/``measure_batch`` retry ``max_retries`` times on
    ``retry_on`` exceptions, sleeping an exponential backoff with
    *deterministic* jitter between attempts: the delay is
    ``backoff_s * 2**attempt * (1 + jitter * u)`` where ``u`` is drawn from
    a counter-keyed rng seeded by the fault-spec seed (``seed``, defaulting
    to the wrapped chaos executor's) — no wall clock, no shared rng state,
    so an identical run journals an identical retry schedule and a restored
    run replays it exactly.  Every retry journals its computed ``delay_s``.
    A batch that keeps failing degrades to per-candidate
    measurement, and candidates that still fail price as ``fallback_cost``
    (infinite by default — they can never win a search), so the MAPE-K loop
    completes and commits a winner instead of crashing mid-plan.  A measure
    exceeding ``timeout_s`` (when set) is treated as failed: the stuck
    result is discarded and ``fallback_cost`` returned.  ``apply`` retries
    too but re-raises on exhaustion — failing to reconfigure the managed
    system is not recoverable by pricing tricks.

    With zero injected faults every call is a single transparent
    pass-through: winners, costs and evaluation counts are bit-identical to
    the unwrapped executor (gated in ``tests/test_torch_chaos.py``).
    """

    def __init__(self, inner, *, max_retries: int = 3, backoff_s: float = 0.0,
                 timeout_s: Optional[float] = None,
                 fallback_cost: float = float("inf"),
                 retry_on: tuple = (SimulatedNodeFailure, TimeoutError),
                 seed: Optional[int] = None, jitter: float = 0.5,
                 max_journal: int = 1024):
        self.inner = inner
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.timeout_s = timeout_s
        self.fallback_cost = float(fallback_cost)
        self.retry_on = tuple(retry_on)
        # jitter derives from the fault-spec seed (the wrapped chaos layer's)
        # so the whole fault+retry schedule replays from one number
        self.seed = int(seed if seed is not None
                        else getattr(inner, "seed", 0))
        self.jitter = float(jitter)
        self.retries = 0
        self.fallbacks = 0
        self.timeouts = 0
        self._retry_seq = 0          # retries ever scheduled (monotone)
        self.journal: deque = deque(maxlen=max_journal)
        if not callable(getattr(inner, "measure_batch", None)):
            self.measure_batch = None
        if not callable(getattr(inner, "measure_batch_arrays", None)):
            self.measure_batch_arrays = None

    def _backoff(self, attempt: int) -> float:
        """The delay before retry ``attempt`` — a pure function of
        (seed, retry sequence number), never of the wall clock, so the
        schedule is replay-stable and journals bit-identically."""
        seq = self._retry_seq
        self._retry_seq += 1
        delay = self.backoff_s * (2 ** attempt)
        if delay and self.jitter:
            rng = np.random.default_rng((self.seed << 24) ^ seq)
            delay *= 1.0 + self.jitter * float(rng.random())
        return delay

    def _sleep_backoff(self, attempt: int, op: str, error) -> None:
        """Journal one failed attempt and (for non-final ones) sleep the
        deterministic backoff; the journaled ``seq``/``delay_s`` pair IS the
        retry schedule — replaying with the same seed reproduces it."""
        entry = {"kind": "retry", "op": op, "attempt": attempt,
                 "error": repr(error)}
        if attempt < self.max_retries:
            self.retries += 1
            entry["seq"] = self._retry_seq
            entry["delay_s"] = self._backoff(attempt)
        self.journal.append(entry)
        if entry.get("delay_s"):
            time.sleep(entry["delay_s"])

    def _attempt(self, fn, op: str):
        """Run ``fn`` with the retry/backoff/timeout policy; returns its
        result or None when the fallback cost should substitute."""
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                out = fn()
            except self.retry_on as e:
                self._sleep_backoff(attempt, op, e)
                if attempt >= self.max_retries:
                    self.fallbacks += 1
                    self.journal.append({"kind": "fallback", "op": op})
                    return None
                continue
            dt = time.perf_counter() - t0
            if self.timeout_s is not None and dt > self.timeout_s:
                self.timeouts += 1
                self.journal.append({"kind": "timeout", "op": op,
                                     "seconds": dt})
                return None
            return out
        return None

    # -- Executor protocol ---------------------------------------------------

    def apply(self, tunables: Tunables) -> None:
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                self.inner.apply(tunables)
                return
            except self.retry_on as e:
                last = e
                self._sleep_backoff(attempt, "apply", e)
        raise last

    # -- durable-session state (see KermitSession.checkpoint) ---------------

    def export_state(self) -> dict:
        return {"retries": self.retries, "fallbacks": self.fallbacks,
                "timeouts": self.timeouts, "retry_seq": self._retry_seq,
                "journal": [dict(e) for e in self.journal]}

    def restore_state(self, state: dict) -> None:
        self.retries = int(state["retries"])
        self.fallbacks = int(state["fallbacks"])
        self.timeouts = int(state["timeouts"])
        self._retry_seq = int(state["retry_seq"])
        self.journal = deque((dict(e) for e in state["journal"]),
                             maxlen=self.journal.maxlen)

    def measure(self) -> float:
        out = self._attempt(self.inner.measure, "measure")
        return self.fallback_cost if out is None else float(out)

    def measure_batch(self, candidates: Sequence[Tunables]) -> list:
        candidates = list(candidates)
        out = self._attempt(lambda: self.inner.measure_batch(candidates),
                            "measure_batch")
        if out is not None:
            return list(out)
        # degrade: price candidates one by one, each with its own retry
        # budget — persistent per-candidate failures cost fallback_cost
        costs = []
        for c in candidates:
            one = self._attempt(lambda c=c: self.inner.measure_batch([c]),
                                "measure_batch[1]")
            costs.append(self.fallback_cost if one is None else float(one[0]))
        return costs

    def measure_batch_arrays(self, arrays: dict) -> np.ndarray:
        out = self._attempt(
            lambda: self.inner.measure_batch_arrays(arrays),
            "measure_batch_arrays")
        if out is not None:
            return np.asarray(out)
        n = len(np.reshape(next(iter(arrays.values())), (-1,)))
        return np.full((n,), self.fallback_cost, np.float64)

    # -- delegated surface (samples, counters, chaos journal, ...) ----------

    def __getattr__(self, name):
        return getattr(self.inner, name)
