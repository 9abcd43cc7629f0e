"""Execute — the E of MAPE-K, as a first-class pluggable boundary.

Port of ``repro/kermit/executor.py``.  The simulator's vectorized cost
model runs as float32 torch ops on the executor's device (the reference
jits it); everything else is host-side Python, copied.

The paper's KERMIT applies selected configurations to the managed system
itself; our seed reproduction left that to the caller by threading an
``objective`` callable through every ``step``.  The ``Executor`` protocol
makes the boundary explicit and swappable (the generality point stressed by
the online-tuning literature: Tuneful, arXiv 2001.08002; arXiv 2309.01901):

  apply(tunables)   reconfigure the managed system (re-jit a step, resize
                    containers, flip a runtime knob, ...)
  measure()         one measured cost (seconds, $ , J, ...) of the system as
                    currently configured — lower is better

The Plan phase's Explorer evaluates a candidate as ``apply(c); measure()``;
when a search commits, the session calls ``apply`` once more with the winner
so the managed system always ends on the selected configuration.

Batched protocol (the Plan-phase fast path)
-------------------------------------------
Executors whose cost model can price candidates without serially occupying
the managed system additionally implement ``BatchExecutor``:

  measure_batch(cands)         costs for a whole candidate list in one call
  measure_batch_arrays(soa)    (optional) costs for a struct-of-arrays
                               candidate batch (configs/base codec) — lets
                               ``Explorer.exhaustive`` stream the full grid
                               without constructing per-candidate objects

Batched measurement is a *probe*: it does not move ``current`` (the session
still applies the committed winner).  ``ExecutorObjective`` bridges an
executor onto the Explorer's objective duck-type, exposing ``batch`` /
``batch_arrays`` only when the executor supports them, so searches fall back
to the sequential path transparently.

Both executors expose one counter surface — ``applied`` / ``measured`` /
``measured_batches`` / ``measure_seconds`` — so benchmarks read one shape.

Ships two implementations:

  CallableExecutor   wraps a legacy ``objective(Tunables) -> float`` (the
                     bridge for existing measured-step objectives); an
                     optional vectorized ``batch_objective`` prices encoded
                     candidate batches in one dispatch
  SimulatorExecutor  drives ``core/simulator.py`` end to end: renders a
                     schedule's telemetry stream and scores configurations
                     with a deterministic synthetic cost model — the default
                     model is jit-vectorized over the struct-of-arrays
                     encoding, so full-grid sweeps run in a handful of
                     device dispatches
"""
from __future__ import annotations

import math
import time
from functools import partial
from typing import (Callable, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.configs.base import (DEFAULT_TUNABLES, TUNABLE_CATEGORIES,
                                Tunables, tunables_to_arrays)
from repro_torch.kernels.dispatch import resolve_device


@runtime_checkable
class Executor(Protocol):
    def apply(self, tunables: Tunables) -> None:
        """Reconfigure the managed system to run with ``tunables``."""
        ...

    def measure(self) -> float:
        """Measured cost of the system as currently configured (lower wins)."""
        ...


@runtime_checkable
class BatchExecutor(Executor, Protocol):
    def measure_batch(self, candidates: Sequence[Tunables]) -> Sequence[float]:
        """Costs for a whole candidate list, one per candidate, in order.
        A probe: must not change the applied configuration."""
        ...


class ExecutorObjective:
    """The Plan phase's candidate evaluator, bridged onto an executor.

    Scalar calls evaluate ``apply(c); measure()``.  When ``batch=True`` and
    the executor implements the batched protocol, the ``batch`` (and, if
    available, ``batch_arrays``) attributes are exposed so the Explorer
    dispatches whole candidate sets per evaluation; otherwise the Explorer
    sees a plain callable and runs sequentially.
    """

    def __init__(self, executor: Executor, *, batch: bool = True):
        self.executor = executor
        if batch:
            mb = getattr(executor, "measure_batch", None)
            if callable(mb):
                self.batch = mb
            mba = getattr(executor, "measure_batch_arrays", None)
            if callable(mba):
                self.batch_arrays = mba

    def __call__(self, tunables: Tunables) -> float:
        self.executor.apply(tunables)
        return self.executor.measure()


class MeasureCounters:
    """The unified Execute-phase counter surface: ``applied`` / ``measured``
    / ``measured_batches`` / ``measure_seconds``.  One shape on every
    executor, one implementation, so benchmarks read true search cost
    without per-class drift."""

    def _init_counters(self) -> None:
        self.applied = 0
        self.measured = 0
        self.measured_batches = 0
        self.measure_seconds = 0.0

    def _count_apply(self, tunables: Tunables) -> None:
        self.current = tunables
        self.applied += 1

    def _count_measure(self, t0: float, n: int = 1,
                       batch: bool = False) -> None:
        """Fold one measurement (``n`` candidates) ending now into the
        counters; ``t0`` is its ``time.perf_counter()`` start."""
        self.measure_seconds += time.perf_counter() - t0
        self.measured += n
        self.measured_batches += batch

    # -- durable-session state (see KermitSession.checkpoint) ---------------

    def export_state(self) -> dict:
        current = getattr(self, "current", None)
        return {"applied": self.applied, "measured": self.measured,
                "measured_batches": self.measured_batches,
                "measure_seconds": self.measure_seconds,
                "current": current.as_dict() if current is not None else None}

    def restore_state(self, state: dict) -> None:
        self.applied = int(state["applied"])
        self.measured = int(state["measured"])
        self.measured_batches = int(state["measured_batches"])
        self.measure_seconds = float(state["measure_seconds"])
        if state.get("current") is not None:
            self.current = Tunables(**state["current"])

    def _measure_batch_impl(self, candidates: Sequence[Tunables],
                            scalar_fn: Callable,
                            arrays_fn: Optional[Callable]) -> list:
        """Shared ``measure_batch`` body: price through the vectorized
        ``arrays_fn`` (struct-of-arrays encoding) when available, else loop
        ``scalar_fn``; counters updated either way."""
        candidates = list(candidates)
        t0 = time.perf_counter()
        if arrays_fn is not None:
            costs = np.asarray(arrays_fn(tunables_to_arrays(candidates)),
                               np.float64).reshape(-1).tolist()
        else:
            costs = [float(scalar_fn(c)) for c in candidates]
        self._count_measure(t0, len(candidates), batch=True)
        return costs

    def _measure_batch_arrays_impl(self, arrays: dict,
                                   arrays_fn: Callable) -> np.ndarray:
        """Shared ``measure_batch_arrays`` body (one vectorized dispatch)."""
        t0 = time.perf_counter()
        costs = np.asarray(arrays_fn(arrays)).reshape(-1)
        self._count_measure(t0, len(costs), batch=True)
        return costs


class CallableExecutor(MeasureCounters):
    """Adapter from the legacy ``objective(Tunables) -> float`` callable.

    ``apply`` stages the configuration; ``measure`` evaluates the wrapped
    objective at the staged point.  ``measure_batch`` prices a candidate
    list in one call: through ``batch_objective`` (a vectorized callable
    over the struct-of-arrays encoding, returning one cost per candidate)
    when given, else by looping the scalar objective — either way the
    counter surface (``applied``/``measured``/``measured_batches``/
    ``measure_seconds``) reports the true search cost without callers
    wrapping the objective themselves.
    """

    def __init__(self, objective: Callable[[Tunables], float],
                 initial: Tunables = DEFAULT_TUNABLES,
                 batch_objective: Optional[Callable] = None):
        self._objective = objective
        self._batch_objective = batch_objective
        if batch_objective is None:
            # hide the arrays fast path from ExecutorObjective probing
            self.measure_batch_arrays = None
        self.current = initial
        self._init_counters()

    def apply(self, tunables: Tunables) -> None:
        self._count_apply(tunables)

    def measure(self) -> float:
        t0 = time.perf_counter()
        cost = float(self._objective(self.current))
        self._count_measure(t0)
        return cost

    def measure_batch(self, candidates: Sequence[Tunables]) -> list:
        return self._measure_batch_impl(candidates, self._objective,
                                        self._batch_objective)

    def measure_batch_arrays(self, arrays: dict) -> np.ndarray:
        """Price a struct-of-arrays candidate batch in one dispatch (only
        exposed when a vectorized ``batch_objective`` was given)."""
        return self._measure_batch_arrays_impl(arrays, self._batch_objective)


# -- the deterministic synthetic cost model ---------------------------------

_REMAT_NONE = TUNABLE_CATEGORIES["remat"].index("none")


def _default_sim_cost(t: Tunables) -> float:
    """Deterministic synthetic step cost with a known optimum
    (microbatches=2, remat="none", attn_q_chunk=1024) — a smooth bowl the
    Explorer's hill-climb can descend, for examples and tests.  The float64
    reference; ``SimulatorExecutor`` prices through the vectorized model so
    scalar and batched evaluations are bit-identical."""
    cost = 1.0
    cost += 0.05 * abs(math.log2(max(t.microbatches, 1)) - 1.0)
    cost += 0.0 if t.remat == "none" else 0.1
    cost += abs(t.attn_q_chunk - 1024) / 8192.0
    return cost


def _default_sim_cost_arrays(arrays: dict, *, device) -> np.ndarray:
    """Vectorized ``_default_sim_cost`` over the struct-of-arrays encoding:
    float32 ops on ``device`` price a whole candidate chunk."""
    def col(name):
        return torch.as_tensor(np.asarray(arrays[name]), device=device)

    mb = torch.clamp_min(col("microbatches").to(torch.float32), 1.0)
    c = 1.0 + 0.05 * torch.abs(torch.log2(mb) - 1.0)
    c = c + torch.where(col("remat") == _REMAT_NONE, 0.0, 0.1)
    c = c + torch.abs(col("attn_q_chunk").to(torch.float32) - 1024.0) / 8192.0
    return c.cpu().numpy()


class SimulatorExecutor(MeasureCounters):
    """Closed-loop executor over ``core/simulator.py``.

    Renders ``schedule`` (a list of ``(archetype, n_windows)`` segments) into
    a ground-truth telemetry stream — ``KermitSession.run()`` feeds
    ``samples`` through the loop — and prices applied configurations with a
    deterministic ``cost`` model, so the full MAPE-K cycle (discover →
    search → retune → reuse) runs end to end with no managed system at all.

    With the default cost model (or an explicit vectorized ``cost_arrays``),
    the executor implements the full batched protocol including
    ``measure_batch_arrays`` — the Explorer's grid sweeps then run as a few
    compiled dispatches instead of one Python round-trip per candidate.
    When a ``cost_arrays`` model is in play, scalar ``measure`` prices
    through it too (a batch of one), so sequential and batched searches see
    bit-identical costs from ONE model; pass an explicit scalar ``cost``
    alongside only if you guarantee the two agree.  A custom scalar ``cost``
    without ``cost_arrays`` still measures batches (by looping), but exposes
    no arrays fast path.
    """

    def __init__(self, schedule, *, window_size: int = 32, seed: int = 0,
                 transition_windows: int = 2, drift: float = 0.0,
                 cost: Optional[Callable[[Tunables], float]] = None,
                 cost_arrays: Optional[Callable[[dict], np.ndarray]] = None,
                 initial: Tunables = DEFAULT_TUNABLES,
                 device=None):
        from repro_torch.core.simulator import generate
        self.device = resolve_device(device)
        self.result = generate(schedule, window_size=window_size, seed=seed,
                               transition_windows=transition_windows,
                               drift=drift)
        if cost_arrays is None and cost is None:
            cost_arrays = partial(_default_sim_cost_arrays,
                                  device=self.device)
        if cost is None and cost_arrays is not None:
            def cost(t, _fn=cost_arrays):
                return float(np.asarray(_fn(tunables_to_arrays([t])))[0])
        self._cost = cost
        self._cost_arrays = cost_arrays
        if cost_arrays is None:
            # hide the arrays fast path from ExecutorObjective probing
            self.measure_batch_arrays = None
        self.current = initial
        self._init_counters()

    @property
    def samples(self):
        """The rendered (N, F) telemetry stream."""
        return self.result.samples

    def apply(self, tunables: Tunables) -> None:
        self._count_apply(tunables)

    def measure(self) -> float:
        t0 = time.perf_counter()
        cost = float(self._cost(self.current))
        self._count_measure(t0)
        return cost

    def measure_batch(self, candidates: Sequence[Tunables]) -> list:
        return self._measure_batch_impl(candidates, self._cost,
                                        self._cost_arrays)

    def measure_batch_arrays(self, arrays: dict) -> np.ndarray:
        """Price a struct-of-arrays candidate batch in one dispatch."""
        return self._measure_batch_arrays_impl(arrays, self._cost_arrays)
