"""WorkloadDB — the Knowledge component of the MAPE-K loop (paper Fig. 11).

Port of ``repro/core/knowledge.py``: the batched Welch match runs as
float32 torch ops on the DB's device; saves are written with a local
atomic-write helper (temp file + fsync + rename), and the JSON format (v3)
is the reference's, so databases move between the two packages.

Entity model (per workload label): characterization statistics, a single
stored configuration, ``has_optimal`` / ``is_drifting`` flags, synthetic
(ZSL-anticipated) provenance, and a drift score.  Labels are auto-generated
unique ints (the paper's integer-counter scheme, chosen to ease libsvm-style
training-file generation).

Invariants (see docs/api.md "Knowledge"):

* **Bounded store.**  At most ``max_records`` records are retained; when the
  bound is hit, eviction prefers synthetic records without a configuration,
  then synthetic, then non-optimal records — least-recently-updated first.
  Labels of *evicted* records are never reused (the counter only grows), and
  labels of *merged* records stay resolvable through the alias map.
* **One distance metric.**  Matching and warm-start ranking both use the L2
  norm between characterization ``mean`` vectors (``characterize.l2_drift``);
  ``find_match`` additionally requires the Welch-test statistical match
  (``ChangeDetector.match_characterization`` semantics) and considers only
  non-synthetic records.  ``nearest_config`` ranks every record with a
  stored config — synthetic (ZSL-anticipated) records are eligible
  warm-start donors.
* **Vectorized hot path.**  Characterizations mirror into a struct-of-arrays
  matrix (row order == record insertion order, the ``configs/base`` codec
  style) so ``find_match`` / ``nearest_config`` are one batched dispatch
  over all records: one batched Welch kernel plus a row-wise numpy
  distance reduction.  The reference's seed per-record loop
  (``impl="legacy"``) is not ported; the reference itself is the parity
  oracle (``tests/test_torch_knowledge.py``).
* **Drift adaptation.**  ``observe`` blends fresh characterizations with an
  EMA floor (``drift_alpha`` — 0 reproduces the seed count-weighted merge),
  tracks a per-record ``drift_score``, and re-anchors a class whose
  cumulative drift diverges past ``rediscover_mult * drift_eps`` (origin
  re-anchored, stale config dropped — the class is "re-discovered" without
  human intervention).  ``consolidate`` merges non-synthetic classes whose
  characterizations converge within ``merge_eps``.  All of these journal
  typed events (drift/merge/evict) that ``KermitSession`` drains into its
  subscription stream.

The knowledge base persists under the HDFS-like zone layout:
  <root>/lz/   raw agent telemetry (JSONL, appended by the monitor/agents)
  <root>/tz/   observation-window series (npz)
  <root>/az/   workloads.json (this DB) + trained model params
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.change_detector import ChangeDetector, _sig_quorum
from repro_torch.core.characterize import l2_drift, merge_characterizations
from repro_torch.kernels.dispatch import resolve_device

UNKNOWN = -1

DB_FORMAT_VERSION = 3           # save() format; load() migrates v1/v2 forward
#   v3 adds the per-record Plan-model state: bounded ``trace`` rows
#   (measured (config, cost) pairs from SearchResult.trace) and the
#   ``sensitivity`` knob ranking — absent fields default on load, so v2
#   databases migrate forward for free

# per-record bound on stored trace rows (newest kept) — the cost-model
# training set for one workload class
TRACE_BOUND = 512

# journal bound for standalone (session-less) use: KermitSession drains the
# journal every analysis, but a bare WorkloadDB driven forever must not
# accumulate adaptation events without limit
JOURNAL_BOUND = 4096

# cumulative-drift divergence multiplier: a class whose mean has wandered
# more than rediscover_mult * drift_eps from its origin anchor is re-anchored
# (re-discovered) instead of merely flagged as drifting
REDISCOVER_MULT = 4.0


def _to_jsonable(c: dict) -> dict:
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}


def _from_jsonable(c: dict) -> dict:
    return {k: (np.asarray(v, np.float32) if isinstance(v, list) else v)
            for k, v in c.items()}


# ---------------------------------------------------------------------------
# Batched Welch match kernel
# ---------------------------------------------------------------------------
#
# The statistical matcher over ALL stored records in one batched pass —
# the batched twin of ``ChangeDetector.match_characterization``.  Row
# arithmetic mirrors ``change_detector.welch_t`` (same operand order, same
# clamps, float32 counts).  Record counts are padded to power-of-two
# buckets, as in the reference, so the shapes a device sees stay few.


def _match_kernel(means, stds, counts, q_mean, q_std, q_n, mask, *,
                  alpha: float, quorum: float):
    """(R, F) record stats vs one query -> (R,) significant-difference flags."""
    var1 = stds * stds
    var2 = q_std * q_std
    v1 = var1 / counts[:, None]
    v2 = (var2 / q_n)[None, :]
    vs = v1 + v2
    denom = torch.sqrt(torch.clamp_min(vs, 1e-12))
    t = (means - q_mean[None, :]) / denom
    dof = torch.square(vs) / torch.clamp_min(
        v1 * v1 / torch.clamp_min(counts[:, None] - 1.0, 1.0)
        + v2 * v2 / torch.clamp_min(q_n - 1.0, 1.0), 1e-12)
    return _sig_quorum(t, dof, mask, alpha, quorum)


def _atomic_write_text(path: Path, text: str) -> None:
    """Crash-consistent write: temp file + fsync + atomic rename (+ a
    best-effort directory fsync), so a crash leaves the old file or the new
    one, never a torn mix."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(text.encode("utf-8"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass                         # not every filesystem supports dir fsync


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


@dataclass
class WorkloadRecord:
    label: int
    characterization: dict
    config: Optional[dict] = None
    has_optimal: bool = False
    is_drifting: bool = False
    is_synthetic: bool = False
    pair: Optional[tuple] = None          # hybrid provenance (k-way combo)
    observations: int = 0
    updated_at: float = field(default_factory=time.time)
    drift_score: float = 0.0              # EMA of observed drift distances
    origin_mean: Optional[np.ndarray] = None   # anchor for divergence checks
    tenant: Optional[int] = None          # fleet owner; None = single-tenant
    trace: list = field(default_factory=list)  # [[config, cost], ...] bounded
    sensitivity: Optional[dict] = None    # knob -> main effect (costmodel)


_RECORD_FIELDS = {f.name for f in dataclasses.fields(WorkloadRecord)}


class WorkloadDB:
    """``impl``: the ``KermitConfig.impl`` policy; every value but
    ``"legacy"``/``"seed"`` (the reference's per-record seed loop, not
    ported) takes the batched match path."""

    def __init__(self, root: str | Path | None = None,
                 drift_eps: float = 1.0,
                 matcher: ChangeDetector | None = None, *,
                 impl: str = "auto",
                 drift_alpha: float = 0.0,
                 merge_eps: float = 0.0,
                 max_records: int = 1024,
                 max_stored_trace: int = TRACE_BOUND,
                 device=None):
        self.device = resolve_device(device)
        self.root = Path(root) if root else None
        self.records: dict[int, WorkloadRecord] = {}
        self.aliases: dict[int, int] = {}     # merged label -> surviving label
        self._next_label = 0
        self.drift_eps = drift_eps
        self.drift_alpha = drift_alpha
        self.merge_eps = merge_eps
        self.max_records = max_records
        self.max_stored_trace = max_stored_trace
        if impl in ("legacy", "seed"):
            raise NotImplementedError(
                "the per-record seed WorkloadDB path is not ported yet "
                "(ROADMAP queue A: legacy/seed paths)")
        self.matcher = matcher or ChangeDetector(alpha=0.001, quorum=0.5,
                                                 device=self.device)
        self._journal: list[dict] = []        # drained by KermitSession
        self._arrays = None                   # SoA mirror; None -> dirty
        if self.root is not None:
            for z in ("lz", "tz", "az"):
                (self.root / z).mkdir(parents=True, exist_ok=True)
            self._load()

    # -- label generation (paper: unique auto-increment ints) --------------

    def new_label(self) -> int:
        l = self._next_label
        self._next_label += 1
        return l

    def resolve(self, label: int) -> int:
        """Follow the alias chain of a merged label to its surviving label."""
        seen = set()
        while label in self.aliases and label not in seen:
            seen.add(label)
            label = self.aliases[label]
        return label

    # -- struct-of-arrays mirror -------------------------------------------

    def _ensure_arrays(self):
        """(Re)build the SoA mirror; row order == record insertion order."""
        if self._arrays is not None:
            return self._arrays
        recs = list(self.records.values())
        if not recs:
            self._arrays = {"n": 0}
            return self._arrays
        self._arrays = {
            "n": len(recs),
            "labels": np.asarray([r.label for r in recs], np.int64),
            "mean": np.stack([np.asarray(r.characterization["mean"],
                                         np.float32) for r in recs]),
            "std": np.stack([np.asarray(r.characterization["std"],
                                        np.float32) for r in recs]),
            "count": np.asarray([r.characterization.get("n", 0)
                                 for r in recs], np.float32),
            "synthetic": np.asarray([r.is_synthetic for r in recs], bool),
            "has_config": np.asarray([r.config is not None for r in recs],
                                     bool),
            "tenant": np.asarray([-1 if r.tenant is None else r.tenant
                                  for r in recs], np.int64),
            "syn_pairs": {r.pair: r.label for r in recs
                          if r.is_synthetic and r.pair is not None},
            "row_of": {r.label: i for i, r in enumerate(recs)},
        }
        return self._arrays

    def _dirty(self):
        self._arrays = None

    def _update_row(self, rec: WorkloadRecord) -> None:
        """Refresh one record's row of the SoA mirror in place — keeps the
        per-cluster find_match→observe alternation of an analysis run from
        rebuilding the whole mirror once per cluster.  Falls back to a full
        rebuild when the record has no row yet (fresh insert)."""
        A = self._arrays
        if A is None:
            return
        i = A.get("row_of", {}).get(rec.label)
        if i is None:
            self._dirty()
            return
        c = rec.characterization
        A["mean"][i] = np.asarray(c["mean"], np.float32)
        A["std"][i] = np.asarray(c["std"], np.float32)
        A["count"][i] = c.get("n", 0)
        A["has_config"][i] = rec.config is not None

    def _trim_journal(self) -> None:
        extra = len(self._journal) - JOURNAL_BOUND
        if extra > 0:
            del self._journal[:extra]

    # -- core operations ----------------------------------------------------

    def find_match(self, char: dict, *,
                   tenant: int | None = None) -> Optional[int]:
        """Statistical match (batched Welch kernel) with an L2 ranking
        among the statistical matches; returns the matching label or None.  Synthetic
        (ZSL-anticipated) records never match — a real observation of an
        anticipated hybrid is a *new* class discovery, not a re-observation.
        ``tenant`` restricts matching to that tenant's records (fleet
        namespace isolation); None considers every record.
        """
        A = self._ensure_arrays()
        R = A["n"]
        if R == 0:
            return None
        sig = self._significant_flags(A, char)
        match = ~sig & ~A["synthetic"]
        if tenant is not None:
            match &= A["tenant"] == tenant
        if not match.any():
            return None
        d = np.linalg.norm(A["mean"] - np.asarray(char["mean"], np.float32),
                           axis=1)
        cand = np.flatnonzero(match)
        # first strict minimum in insertion order, as the reference's
        # per-record ``d < best_d`` scan (np.argmin returns the first one)
        return int(A["labels"][cand[np.argmin(d[cand])]])

    def _significant_flags(self, A, char: dict) -> np.ndarray:
        """One batched pass: Welch significant-difference flag per record
        (bucket-padded, as in the reference)."""
        R = A["n"]
        B = _bucket(R)
        means, stds, counts = A["mean"], A["std"], A["count"]
        if B != R:
            F = means.shape[1]
            means = np.concatenate(
                [means, np.zeros((B - R, F), np.float32)])
            stds = np.concatenate([stds, np.ones((B - R, F), np.float32)])
            counts = np.concatenate([counts, np.full(B - R, 2, np.float32)])
        m = self.matcher
        dev = self.device

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        mask = None if m.feature_mask is None else torch.as_tensor(
            np.asarray(m.feature_mask, bool), device=dev)
        flags = _match_kernel(
            f32(means), f32(stds), f32(counts), f32(char["mean"]),
            f32(char["std"]), f32(char["n"]), mask, alpha=m.alpha,
            quorum=m.quorum)
        return flags.cpu().numpy()[:R]

    def find_synthetic(self, combo: tuple) -> Optional[int]:
        """Label of the synthetic record anticipating ``combo`` (a sorted
        tuple of pure labels), or None — lets the analyser reuse one record
        per hybrid class across analysis runs instead of re-inserting.
        O(1) through the combo index maintained with the SoA mirror."""
        return self._ensure_arrays().get("syn_pairs", {}).get(tuple(combo))

    def refresh_synthetic(self, label: int, prototype: dict) -> None:
        """Replace a synthetic record's prototype (re-synthesis of a combo
        the knowledge base already anticipates keeps its label)."""
        rec = self.records[self.resolve(label)]
        rec.characterization = prototype
        rec.updated_at = time.time()
        self._update_row(rec)

    def insert(self, char: dict, *, is_synthetic=False, pair=None,
               label: int | None = None, tenant: int | None = None) -> int:
        label = self.new_label() if label is None else label
        self._next_label = max(self._next_label, label + 1)
        self.records[label] = WorkloadRecord(
            label=label, characterization=char, is_synthetic=is_synthetic,
            pair=tuple(pair) if pair is not None else None,
            observations=char.get("n", 0),
            origin_mean=np.asarray(char["mean"], np.float32).copy(),
            tenant=tenant)
        self.aliases.pop(label, None)
        self._trim_journal()
        self._dirty()
        self._enforce_bound(protect=label)
        return label

    def observe(self, label: int, char: dict) -> bool:
        """Update a known workload with a fresh characterization; returns
        True when drift was detected (Algorithm 2 drift branch).

        ``drift_alpha`` > 0 gives the fresh batch at least that blend weight
        (an EMA floor), so a long-lived class keeps tracking a slowly
        drifting workload instead of freezing under its own history;
        ``drift_alpha`` = 0 reproduces the seed count-weighted merge
        bit-for-bit.  Cumulative drift beyond ``REDISCOVER_MULT * drift_eps``
        from the origin anchor re-discovers the class: the anchor is reset
        and any stored configuration is dropped as stale.
        """
        label = self.resolve(label)
        rec = self.records[label]
        d = l2_drift(rec.characterization, char)
        drift = d > self.drift_eps
        if self.drift_alpha > 0.0:
            rec.drift_score = ((1.0 - self.drift_alpha) * rec.drift_score
                               + self.drift_alpha * d)
        else:
            rec.drift_score = d
        if drift:
            rec.is_drifting = True
            rec.has_optimal = False
        rec.characterization = merge_characterizations(
            rec.characterization, char, min_new_weight=self.drift_alpha)
        if self.drift_alpha > 0.0 and char.get("n", 0) > 0:
            # an EMA with floor alpha remembers ~1/alpha batches, so the
            # effective evidence count is bounded too — without this cap the
            # Welch matcher grows unboundedly confident in the stored mean
            # and rejects even a perfectly-tracking drifting class
            rec.characterization["n"] = min(
                rec.characterization["n"],
                max(int(round(char["n"] / self.drift_alpha)), char["n"]))
        rec.observations += char.get("n", 0)
        rec.updated_at = time.time()
        rediscovered = False
        if rec.origin_mean is not None:
            wander = float(np.linalg.norm(
                np.asarray(rec.characterization["mean"], np.float32)
                - rec.origin_mean))
            if wander > REDISCOVER_MULT * self.drift_eps:
                # divergence: the class is no longer the one that was
                # characterized at insert — re-anchor it as a new identity
                rec.origin_mean = np.asarray(
                    rec.characterization["mean"], np.float32).copy()
                rec.config = None
                rec.has_optimal = False
                rec.is_drifting = False
                rediscovered = True
        if drift or rediscovered:
            self._trim_journal()
            self._journal.append({
                "kind": "drift", "label": label,
                "detail": {"distance": float(d),
                           "score": float(rec.drift_score),
                           "rediscovered": rediscovered}})
        self._update_row(rec)
        return drift

    def set_config(self, label: int, config: dict, optimal: bool):
        rec = self.records[self.resolve(label)]
        rec.config = dict(config)
        rec.has_optimal = optimal
        if optimal:
            rec.is_drifting = False
        rec.updated_at = time.time()
        self._update_row(rec)

    def get(self, label: int) -> Optional[WorkloadRecord]:
        return self.records.get(self.resolve(label))

    # -- Plan-model state (see core/costmodel.py) --------------------------

    def record_trace(self, label: int, rows) -> None:
        """Append measured ``(config, cost)`` rows (a SearchResult.trace)
        to the record's bounded history — the cost-model training set.
        Deliberately does NOT touch ``updated_at``: storing evidence must
        not perturb the eviction order a search would otherwise leave."""
        rec = self.records[self.resolve(label)]
        for cfg, cost in rows:
            rec.trace.append([dict(cfg), float(cost)])
        if len(rec.trace) > self.max_stored_trace:
            del rec.trace[:len(rec.trace) - self.max_stored_trace]

    def get_trace(self, label: int) -> list:
        rec = self.records.get(self.resolve(label))
        return [] if rec is None else [(dict(c), float(v))
                                       for c, v in rec.trace]

    def set_sensitivity(self, label: int, sens: dict) -> None:
        rec = self.records[self.resolve(label)]
        rec.sensitivity = {str(k): float(v) for k, v in sens.items()}

    def get_sensitivity(self, label: int) -> Optional[dict]:
        rec = self.records.get(self.resolve(label))
        if rec is None or rec.sensitivity is None:
            return None
        return dict(rec.sensitivity)

    def nearest_config(self, char: dict, *, exclude_label: int | None = None,
                       tenant: int | None = None) -> Optional[tuple]:
        """Warm-start lookup: the stored configuration whose workload
        characterization is nearest (L2 over means) to ``char``.  Unlike
        ``find_match`` this ranks *synthetic* (ZSL-anticipated) records too —
        an anticipated hybrid's configuration is exactly what a never-seen
        workload should start its search from.  ``tenant`` restricts donors
        to one tenant's records; the default (None) is tenant-agnostic —
        the fleet's cross-tenant warm-start transfer path.
        ``exclude_label`` is resolved through the alias map first, so
        excluding a merged (absorbed) label excludes its surviving record.
        Returns ``(config, label, distance)`` or None when no record has a
        config."""
        if exclude_label is not None:
            exclude_label = self.resolve(exclude_label)
        A = self._ensure_arrays()
        if A["n"] == 0:
            return None
        ok = A["has_config"].copy()
        if exclude_label is not None:
            ok &= A["labels"] != exclude_label
        if tenant is not None:
            ok &= A["tenant"] == tenant
        if not ok.any():
            return None
        d = np.linalg.norm(A["mean"] - np.asarray(char["mean"], np.float32),
                           axis=1)
        cand = np.flatnonzero(ok)
        i = cand[np.argmin(d[cand])]
        label = int(A["labels"][i])
        return dict(self.records[label].config), label, float(d[i])

    def pure_characterizations(self) -> dict:
        return {l: r.characterization for l, r in self.records.items()
                if not r.is_synthetic}

    def labels(self):
        return sorted(self.records)

    # -- convergence / bound maintenance -------------------------------------

    def consolidate(self, *, tenant: int | None = None) -> list[dict]:
        """Merge non-synthetic classes whose characterizations have converged
        within ``merge_eps`` (vectorized pairwise distances, newer label
        aliased onto older), then enforce the record bound.  Merging never
        crosses tenant tags — two tenants' records stay distinct classes no
        matter how close their characterizations — and ``tenant`` restricts
        the pass to one tenant's records (the fleet's per-tenant analysis
        scope).  Returns the journal entries this pass produced (they also
        stay queued for ``drain_events``)."""
        self._trim_journal()
        start = len(self._journal)
        if self.merge_eps > 0.0:
            while True:
                recs = [r for r in self.records.values()
                        if not r.is_synthetic
                        and (tenant is None or r.tenant == tenant)]
                if len(recs) < 2:
                    break
                M = np.stack([np.asarray(r.characterization["mean"],
                                         np.float32) for r in recs])
                D = np.linalg.norm(M[:, None, :] - M[None, :, :], axis=-1)
                iu = np.triu_indices(len(recs), k=1)
                close = D[iu] < self.merge_eps
                T = np.asarray([-1 if r.tenant is None else r.tenant
                                for r in recs], np.int64)
                close &= T[iu[0]] == T[iu[1]]
                if not close.any():
                    break
                k = int(np.flatnonzero(close)[np.argmin(D[iu][close])])
                a, b = recs[iu[0][k]], recs[iu[1][k]]
                old, new = ((a, b) if a.label < b.label else (b, a))
                self._merge_into(old, new)
        self._enforce_bound()
        return self._journal[start:]

    def _merge_into(self, old: WorkloadRecord, new: WorkloadRecord):
        dist = l2_drift(old.characterization, new.characterization)
        n_new = new.characterization.get("n", 0)
        old.characterization = merge_characterizations(
            old.characterization, new.characterization,
            min_new_weight=self.drift_alpha)
        if self.drift_alpha > 0.0 and n_new > 0:
            # same effective-evidence bound as ``observe``: an adapting
            # class must not grow unboundedly confident through merges
            old.characterization["n"] = min(
                old.characterization["n"],
                max(int(round(n_new / self.drift_alpha)), n_new))
        old.observations += new.observations
        # keep the best configuration either side holds: the absorbed
        # record's tuned optimum must survive a merge with a config-less or
        # stale-config survivor
        if new.config is not None and (
                old.config is None or
                (new.has_optimal and not old.has_optimal)):
            old.config = new.config
            old.has_optimal = new.has_optimal
        # absorbed measurement evidence survives the merge (bounded)
        old.trace += new.trace
        if len(old.trace) > self.max_stored_trace:
            del old.trace[:len(old.trace) - self.max_stored_trace]
        if old.sensitivity is None:
            old.sensitivity = new.sensitivity
        old.updated_at = time.time()
        self.aliases[new.label] = old.label
        # aliases that pointed at the absorbed label re-target the survivor
        for k, v in list(self.aliases.items()):
            if v == new.label:
                self.aliases[k] = old.label
        del self.records[new.label]
        self._journal.append({
            "kind": "merge", "label": old.label,
            "detail": {"absorbed": new.label, "distance": dist}})
        self._dirty()

    def _enforce_bound(self, protect: int | None = None):
        """Evict down to ``max_records``.  ``protect`` exempts a label (the
        record ``insert`` just created — it must never return a dangling
        label, so the bound may transiently sit one over)."""
        if len(self.records) <= self.max_records:
            return
        # eviction priority: synthetic w/o config, synthetic, non-optimal,
        # anything — least-recently-updated first within each class
        def key(rec: WorkloadRecord):
            cls = (0 if rec.is_synthetic and rec.config is None
                   else 1 if rec.is_synthetic
                   else 2 if not rec.has_optimal else 3)
            return (cls, rec.updated_at)
        while len(self.records) > self.max_records:
            victim = min(self.records.values(), key=key)
            if victim.label == protect:
                # the natural victim is the record just inserted: keep the
                # store transiently one over rather than either returning a
                # dangling label or evicting a higher-priority record
                break
            del self.records[victim.label]
            self.aliases = {k: v for k, v in self.aliases.items()
                            if k != victim.label and v != victim.label}
            self._journal.append({
                "kind": "evict", "label": victim.label,
                "detail": {"synthetic": victim.is_synthetic,
                           "had_optimal": victim.has_optimal}})
        self._dirty()

    def drain_events(self) -> list[dict]:
        """Hand the queued drift/merge/evict journal entries to the caller
        (KermitSession emits them as typed AutonomicEvents) and clear it."""
        out, self._journal = self._journal, []
        return out

    # -- persistence (az zone) ----------------------------------------------
    #
    # save()/load() are an explicit, symmetric round-trip API: save(path) on
    # one DB followed by load(path) on another reproduces every record
    # exactly — including hybrid ``pair`` provenance (tuples, which JSON
    # would silently degrade to lists), the label counter, the alias map and
    # the drift state (score + origin anchor).  load() migrates v1 databases
    # (the pre-vectorization schema) forward: missing drift fields default,
    # the origin anchor re-anchors at the stored characterization.

    def _db_path(self, path: str | Path | None) -> Optional[Path]:
        if path is not None:
            return Path(path)
        if self.root is None:
            return None
        return self.root / "az" / "workloads.json"

    def to_state(self) -> dict:
        """The current-format (v2) JSON-able snapshot of the whole store —
        the ``save`` payload, also embedded verbatim in session checkpoints
        (``KermitSession.checkpoint``)."""
        return {
            "version": DB_FORMAT_VERSION,
            "next_label": self._next_label,
            "aliases": {str(k): v for k, v in self.aliases.items()},
            "records": [
                dict(asdict(r),
                     characterization=_to_jsonable(r.characterization),
                     origin_mean=(None if r.origin_mean is None
                                  else np.asarray(r.origin_mean).tolist()))
                for r in self.records.values()],
        }

    def save(self, path: str | Path | None = None):
        """Crash-consistently persist all records (to ``root``'s az zone, or
        an explicit ``path`` for root-less in-memory DBs): temp file + fsync
        + atomic rename, so a crash mid-save leaves the previous snapshot
        intact (at worst plus a stale ``.tmp`` the next save overwrites)."""
        out_path = self._db_path(path)
        if out_path is None:
            return
        _atomic_write_text(out_path, json.dumps(self.to_state()))

    def load(self, path: str | Path | None = None) -> bool:
        """Replace this DB's records with the saved state at ``path`` (or
        ``root``'s az zone).  Returns False when nothing exists there.
        Accepts both the current format and v1 databases (no version field)."""
        in_path = self._db_path(path)
        if in_path is None or not in_path.exists():
            return False
        self.load_state(json.loads(in_path.read_text()))
        return True

    def load_state(self, raw: dict) -> None:
        """Replace this DB's records with a ``to_state``-shaped dict (the
        ``load`` body, exposed for session restore)."""
        self._next_label = raw["next_label"]
        self.aliases = {int(k): int(v)
                        for k, v in raw.get("aliases", {}).items()}
        self.records = {}
        for r in raw["records"]:
            r = {k: v for k, v in r.items() if k in _RECORD_FIELDS}
            r["characterization"] = _from_jsonable(r["characterization"])
            r["pair"] = tuple(r["pair"]) if r.get("pair") else None
            om = r.get("origin_mean")
            r["origin_mean"] = (np.asarray(om, np.float32) if om is not None
                                else np.asarray(r["characterization"]["mean"],
                                                np.float32).copy())
            rec = WorkloadRecord(**r)
            self.records[rec.label] = rec
        self._dirty()

    def _load(self):
        self.load()
