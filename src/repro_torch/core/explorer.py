"""Explorer: the on-line configuration-search engine (Genkin et al. [16]).

Port of ``repro/core/explorer.py`` (numpy; copied, same memo
semantics, winners, costs and evaluation counts).

The search space is the discrete runtime-tunable grid (configs/base.Tunables —
the TPU analogue of YARN container memory/vcores and Spark executor knobs).

* ``global_search`` — the paper's low-overhead coordinate hill-climb: sweep
  each knob in impact order keeping the best value, repeat until a fixed
  point (few tens of evaluations on a grid of thousands).
* ``local_search``  — re-optimization after drift: neighbours-only moves from
  the last good configuration.
* ``exhaustive``    — full grid; the benchmark's "best possible tuning"
  reference for the paper's 92.5%-efficiency claim.

The objective is any callable(Tunables) -> float cost (measured step seconds
on a live system; the dominant roofline term in the dry-run hillclimb).
Evaluations are memoised — repeated workloads cost nothing, which is exactly
the KERMIT plug-in's reuse story.

Batched evaluation
------------------
When the objective exposes the batched protocol (``ExecutorObjective`` over
an executor with ``measure_batch`` — see repro/kermit/executor.py), each
coordinate sweep dispatches its whole candidate set in ONE evaluation:
``global_search`` batches all candidate values of a knob, ``local_search``
batches the neighbour ring of the current best, and ``exhaustive`` streams
the full grid in bounded ``chunk``-sized slices (with ``batch_arrays``, the
grid is enumerated as struct-of-arrays device batches and never constructs
per-candidate Python objects).  Commits scan batch results in index order
with the same strict-improvement rule as the sequential path (first-improving
index wins ties), so batched and sequential searches commit identical
winners; objectives without the protocol fall back to the sequential path
transparently.  Pass ``batched=False`` to force the sequential path (the
benchmark baseline).
"""
from __future__ import annotations

import itertools
import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.base import (DEFAULT_TUNABLES, Tunables,
                                encode_tunable_values, tunables_to_arrays)

# knob -> candidate values, in rough order of expected performance impact
DEFAULT_SPACE = {
    "remat": ["dots", "none", "full"],
    "microbatches": [1, 2, 4, 8],
    "seq_parallel": [False, True],
    "attn_q_chunk": [512, 1024, 2048],
    "capacity_factor": [1.0, 1.25, 1.5, 2.0],
    "ssm_chunk": [128, 256, 512],
    "grad_compression": [False, True],
    "prefetch": [1, 2, 4],
}


@dataclass
class SearchResult:
    best: Tunables
    cost: float
    evaluations: int
    trace: list = field(default_factory=list)


class Explorer:
    """``max_memo`` bounds the evaluation cache (LRU eviction).  The memo
    stores *measured costs*, which are only meaningful for the workload they
    were measured under — callers (KermitPlugin) must ``clear()`` it when the
    active workload label changes or drifts, otherwise one workload's costs
    silently masquerade as another's.

    ``max_trace`` bounds ``SearchResult.trace`` (oldest entries evicted;
    ``evaluations`` stays exact), so full-grid sweeps hold constant memory.
    ``chunk`` is the batched-``exhaustive`` streaming slice size — it bounds
    both peak candidate-batch memory and compiled-program trace growth."""

    def __init__(self, space: dict | None = None, max_passes: int = 3,
                 max_memo: int = 4096, max_trace: int = 4096,
                 chunk: int = 512):
        self.space = dict(space or DEFAULT_SPACE)
        # declarative configs (PlanConfig.space, JSON experiment specs) make
        # knob-name typos easy — fail at construction, not mid-search
        unknown = [k for k in self.space if not hasattr(DEFAULT_TUNABLES, k)]
        if unknown:
            raise ValueError(
                f"unknown Tunables knob(s) in search space: {unknown}")
        if max_trace < 1:
            raise ValueError("max_trace must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.max_passes = max_passes
        self.max_memo = max_memo
        self.max_trace = max_trace
        self.chunk = chunk
        self._memo: OrderedDict = OrderedDict()

    def clear(self) -> None:
        """Drop all memoised costs (workload changed or drifted)."""
        self._memo.clear()

    def grid_size(self) -> int:
        """Number of points in the full search grid."""
        return int(np.prod([len(v) for v in self.space.values()])) \
            if self.space else 1

    def subspace(self, keep) -> "Explorer":
        """A fresh Explorer (same bounds, empty memo) over only the ``keep``
        knobs.  Knobs outside the sub-space are held at whatever ``start``
        each search is given — the significance-pruned search pins
        insignificant knobs to warm-start values exactly this way."""
        keep = set(keep)
        sub = {k: v for k, v in self.space.items() if k in keep}
        if not sub:
            raise ValueError("subspace(keep=...) selects no knobs")
        return Explorer(sub, max_passes=self.max_passes,
                        max_memo=self.max_memo, max_trace=self.max_trace,
                        chunk=self.chunk)

    def memo_size(self) -> int:
        # deliberately not __len__: an empty-memo Explorer must stay truthy
        # (callers use the ``explorer or Explorer()`` idiom)
        return len(self._memo)

    # -- durable-session state (see KermitSession.checkpoint) ---------------

    def export_memo(self) -> list:
        """JSON-able snapshot of the memo, LRU order preserved — a restored
        search reuses the same cached costs (and hence evaluation counts)."""
        return [[[[name, value] for name, value in key], cost]
                for key, cost in self._memo.items()]

    def restore_memo(self, entries) -> None:
        self._memo = OrderedDict(
            (tuple((name, value) for name, value in key), float(cost))
            for key, cost in entries)

    def _key(self, tun: Tunables):
        return tuple(sorted(tun.as_dict().items()))

    def _new_trace(self) -> deque:
        return deque(maxlen=self.max_trace)

    def _eval(self, objective, tun: Tunables, counter: list,
              trace) -> float:
        k = self._key(tun)
        if k not in self._memo:
            self._memo[k] = float(objective(tun))
            counter[0] += 1
            trace.append((tun.as_dict(), self._memo[k]))
            while len(self._memo) > self.max_memo:
                self._memo.popitem(last=False)
        else:
            self._memo.move_to_end(k)
        return self._memo[k]

    def _eval_batch(self, objective, cands: list, counter: list,
                    trace) -> list:
        """Evaluate ``cands`` through one ``objective.batch`` dispatch,
        consulting/filling the memo exactly like per-candidate ``_eval``
        would (memo hits and in-batch duplicates are not re-counted)."""
        keys = [self._key(c) for c in cands]
        out = {}
        pending, pending_keys, seen = [], [], set()
        for c, k in zip(cands, keys):
            if k in self._memo:
                self._memo.move_to_end(k)
                out[k] = self._memo[k]
            elif k not in seen:
                seen.add(k)
                pending.append(c)
                pending_keys.append(k)
        if pending:
            batch_fn = getattr(objective, "batch", None)
            costs = (batch_fn(pending) if batch_fn is not None
                     else [objective(c) for c in pending])
            if len(costs) != len(pending):
                raise ValueError(
                    f"batched objective returned {len(costs)} costs for "
                    f"{len(pending)} candidates")
            for c, k, v in zip(pending, pending_keys, costs):
                v = float(v)
                out[k] = v
                self._memo[k] = v
                counter[0] += 1
                trace.append((c.as_dict(), v))
            while len(self._memo) > self.max_memo:
                self._memo.popitem(last=False)
        return [out[k] for k in keys]

    @staticmethod
    def _use_batch(objective, batched) -> bool:
        if batched is False:
            return False
        has = getattr(objective, "batch", None) is not None
        if batched and not has:
            return False                      # fall back transparently
        return has

    # -- searches ------------------------------------------------------------

    def global_search(self, objective, start: Tunables = DEFAULT_TUNABLES, *,
                      batched: bool | None = None) -> SearchResult:
        """Coordinate hill-climb.  Each knob sweep's candidate set is fixed
        at sweep start (replacing one knob of the current best), evaluated
        batched or sequentially, then committed by an in-order scan with the
        strict-improvement rule — both paths pick identical winners."""
        use_batch = self._use_batch(objective, batched)
        best = start
        counter, trace = [0], self._new_trace()
        best_cost = self._eval(objective, best, counter, trace)
        for _ in range(self.max_passes):
            improved = False
            for knob, values in self.space.items():
                cands = [best.replace(**{knob: v}) for v in values
                         if getattr(best, knob) != v]
                if use_batch:
                    costs = self._eval_batch(objective, cands, counter, trace)
                else:
                    costs = [self._eval(objective, c, counter, trace)
                             for c in cands]
                for cand, c in zip(cands, costs):
                    if c < best_cost - 1e-12:
                        best, best_cost, improved = cand, c, True
            if not improved:
                break
        return SearchResult(best, best_cost, counter[0], list(trace))

    def local_search(self, objective, start: Tunables, *,
                     batched: bool | None = None) -> SearchResult:
        """Neighbour moves only: each sweep evaluates the full one-grid-step
        neighbour ring of the current best (all computed from the same base,
        so the ring is one batched dispatch), commits the in-order winner,
        and repeats until no neighbour improves."""
        use_batch = self._use_batch(objective, batched)
        best = start
        counter, trace = [0], self._new_trace()
        best_cost = self._eval(objective, best, counter, trace)
        improved = True
        while improved:
            improved = False
            ring = []
            for knob, values in self.space.items():
                cur = getattr(best, knob)
                if cur not in values:
                    continue
                i = values.index(cur)
                for j in (i - 1, i + 1):
                    if 0 <= j < len(values):
                        ring.append(best.replace(**{knob: values[j]}))
            if use_batch:
                costs = self._eval_batch(objective, ring, counter, trace)
            else:
                costs = [self._eval(objective, c, counter, trace)
                         for c in ring]
            for cand, c in zip(ring, costs):
                if c < best_cost - 1e-12:
                    best, best_cost, improved = cand, c, True
        return SearchResult(best, best_cost, counter[0], list(trace))

    def exhaustive(self, objective, start: Tunables = DEFAULT_TUNABLES, *,
                   batched: bool | None = None) -> SearchResult:
        """Full grid sweep.  ``start`` supplies the values of every knob NOT
        in the search space (consistent with the other searches).  With a
        ``batch_arrays`` objective the grid streams as struct-of-arrays
        chunks and never builds per-candidate Python objects (this fast path
        bypasses the memo — every grid point is priced and counted); with
        ``batch`` it streams memoised Tunables chunks; otherwise it runs the
        sequential seed path."""
        arrays_fn = getattr(objective, "batch_arrays", None)
        if batched is not False and arrays_fn is not None:
            return self._exhaustive_arrays(arrays_fn, start)
        use_batch = self._use_batch(objective, batched)
        counter, trace = [0], self._new_trace()
        best, best_cost = None, math.inf
        knobs = list(self.space)
        combos = itertools.product(*(self.space[k] for k in knobs))
        while True:
            block = list(itertools.islice(combos, self.chunk))
            if not block:
                break
            cands = [start.replace(**dict(zip(knobs, cb))) for cb in block]
            if use_batch:
                costs = self._eval_batch(objective, cands, counter, trace)
            else:
                costs = [self._eval(objective, c, counter, trace)
                         for c in cands]
            for cand, c in zip(cands, costs):
                if c < best_cost:
                    best, best_cost = cand, c
        return SearchResult(best, best_cost, counter[0], list(trace))

    def _grid_chunks(self, start: Tunables):
        """Yield ``(lo, soa)`` struct-of-arrays slices of the full grid in
        mixed-radix enumeration order (itertools.product order, last knob
        fastest): per-knob encoded value columns over a broadcast ``start``
        base, ``chunk`` candidates per slice."""
        knobs = list(self.space)
        counts = [len(self.space[k]) for k in knobs]
        total = int(np.prod(counts)) if knobs else 1
        strides = {}
        stride = 1
        for k, n in zip(reversed(knobs), reversed(counts)):
            strides[k] = stride
            stride *= n
        cols = {k: encode_tunable_values(k, self.space[k]) for k in knobs}
        base = tunables_to_arrays([start])
        for lo in range(0, total, self.chunk):
            hi = min(lo + self.chunk, total)
            idx = np.arange(lo, hi)
            soa = {name: np.broadcast_to(arr, (hi - lo,))
                   for name, arr in base.items()}
            for k, n in zip(knobs, counts):
                soa[k] = cols[k][(idx // strides[k]) % n]
            yield lo, soa

    def _exhaustive_arrays(self, arrays_fn, start: Tunables) -> SearchResult:
        """Grid streaming over the struct-of-arrays codec, one vectorized
        cost dispatch per chunk.  The trace records improving chunk winners
        only (the full per-candidate log would cost exactly the Python loop
        this path exists to avoid)."""
        counter, trace = [0], self._new_trace()
        best_idx, best_cost = -1, math.inf
        for lo, soa in self._grid_chunks(start):
            hi = lo + len(next(iter(soa.values())))
            costs = np.asarray(arrays_fn(soa)).reshape(-1)
            if len(costs) != hi - lo:
                raise ValueError(
                    f"batch_arrays returned {len(costs)} costs for a "
                    f"{hi - lo}-candidate chunk")
            counter[0] += hi - lo
            j = int(costs.argmin())
            if float(costs[j]) < best_cost:
                best_cost = float(costs[j])
                best_idx = lo + j
                trace.append((self._decode_index(start, best_idx).as_dict(),
                              best_cost))
        best = self._decode_index(start, best_idx) if best_idx >= 0 else None
        return SearchResult(best, best_cost, counter[0], list(trace))

    def model_ranked_exhaustive(self, objective, start: Tunables,
                                predict_fn, *, max_evals: int,
                                refine: bool = True) -> SearchResult:
        """Model-guided budgeted grid search (ROADMAP item 4).

        Rank phase: ``predict_fn`` (a trained ``CostModel.predict_arrays``)
        prices the WHOLE grid as struct-of-arrays chunks — model inference
        only, zero real measurements.  Probe phase: the best-predicted
        candidates are measured for real (memoised, batched when the
        objective offers the protocol) in predicted order and committed
        with the same first-improving strict rule as every other search.
        Refine phase (``refine=True``): neighbour-ring hill-climb from the
        measured winner, sharing the probe budget.  Real measurements are
        hard-capped at ``max_evals`` (memo hits stay free);
        ``SearchResult.evaluations`` counts real measurements only."""
        total = self.grid_size()
        max_evals = max(1, min(int(max_evals), total))
        preds = np.empty(total, np.float64)
        for lo, soa in self._grid_chunks(start):
            n = len(next(iter(soa.values())))
            got = np.asarray(predict_fn(soa)).reshape(-1)
            if len(got) != n:
                raise ValueError(
                    f"predict_fn returned {len(got)} predictions for a "
                    f"{n}-candidate chunk")
            preds[lo:lo + n] = got
        order = np.argsort(preds, kind="stable")   # ties -> lower grid index
        probe = max_evals if not refine else max(1, -(-max_evals // 2))
        use_batch = self._use_batch(objective, None)
        counter, trace = [0], self._new_trace()
        best, best_cost = None, math.inf
        cands = [self._decode_index(start, int(i)) for i in order[:probe]]
        for i in range(0, len(cands), self.chunk):
            block = cands[i:i + self.chunk]
            costs = (self._eval_batch(objective, block, counter, trace)
                     if use_batch else
                     [self._eval(objective, c, counter, trace)
                      for c in block])
            for cand, c in zip(block, costs):
                if c < best_cost:
                    best, best_cost = cand, c
        improved = refine
        while improved and counter[0] < max_evals:
            improved = False
            ring = []
            for knob, values in self.space.items():
                cur = getattr(best, knob)
                if cur not in values:
                    continue
                i = values.index(cur)
                for j in (i - 1, i + 1):
                    if 0 <= j < len(values):
                        ring.append(best.replace(**{knob: values[j]}))
            # trim the ring so unmemoised measurements never exceed the
            # budget (memo hits are free and always kept)
            room = max_evals - counter[0]
            block, misses, seen = [], 0, set()
            for c in ring:
                k = self._key(c)
                if k in self._memo:
                    block.append(c)
                elif k not in seen and misses < room:
                    seen.add(k)
                    misses += 1
                    block.append(c)
            if not block:
                break
            costs = (self._eval_batch(objective, block, counter, trace)
                     if use_batch else
                     [self._eval(objective, c, counter, trace)
                      for c in block])
            for cand, c in zip(block, costs):
                if c < best_cost - 1e-12:
                    best, best_cost, improved = cand, c, True
        return SearchResult(best, best_cost, counter[0], list(trace))

    def _decode_index(self, start: Tunables, index: int) -> Tunables:
        """Mixed-radix grid index -> Tunables (product enumeration order)."""
        kw = {}
        for knob in reversed(list(self.space)):
            values = self.space[knob]
            kw[knob] = values[index % len(values)]
            index //= len(values)
        return start.replace(**kw)
