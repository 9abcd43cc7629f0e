"""Observation windows and the telemetry feature vector (port of
``repro/core/windows.py``; numpy only, copied: ``WindowRing`` for one
session, ``BatchedWindowRing`` for the fleet's S lockstep tenants).

The paper's feature vector is built from container performance metrics
(cpu/io/net); our TPU adaptation uses step telemetry of the same
dimensionality class. A *workload* Ω is a run of observation windows with no
statistically-meaningful inter-window change; a *workload transition* is a run
of windows with significant change (DESIGN.md §1).

An observation window aggregates ``window_size`` raw samples and carries
(mean, var, n) per feature so Welch's test can run on any pair of windows.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FEATURES = [
    "step_time",        # s
    "tokens_per_s",     # throughput
    "mfu",              # model-flops utilization proxy [0,1]
    "hbm_util",         # memory-bandwidth utilization proxy [0,1]
    "coll_frac",        # fraction of step in collectives [0,1]
    "host_wait",        # input-pipeline stall fraction [0,1]
    "peak_mem_frac",    # HBM high-water mark fraction [0,1]
    "grad_norm",        # training only
    "loss_delta",       # training only
    "expert_imbalance", # MoE only; 1.0 = perfectly balanced
    "cache_occ",        # serving: KV-cache occupancy [0,1]
    "seq_len_log",      # log2 seq-len / 20
    "batch_log",        # log2 global batch / 10
    "decode_frac",      # fraction of steps that are decode [0,1]
    "recompute_frac",   # remat recompute fraction [0,1]
    "io_rate",          # host ingest GB/s (normalized)
]
NUM_FEATURES = len(FEATURES)


@dataclass
class WindowSeries:
    """A batch of observation windows: mean/var/n per window."""
    mean: np.ndarray          # (n_windows, F)
    var: np.ndarray           # (n_windows, F)
    count: int                # samples per window

    def __len__(self):
        return self.mean.shape[0]

    def slice(self, sl):
        return WindowSeries(self.mean[sl], self.var[sl], self.count)

    def concat(self, other: "WindowSeries") -> "WindowSeries":
        assert self.count == other.count
        return WindowSeries(np.concatenate([self.mean, other.mean]),
                            np.concatenate([self.var, other.var]), self.count)


class WindowRing:
    """Preallocated bounded storage for per-window monitor state (mean, var,
    label).  Retains the most recent ``capacity`` windows; ``total`` counts
    every window ever pushed, so window ids and history-length gates keep
    working after eviction.  Chronological reads (``ordered``/``series``) are
    zero-copy views until the ring wraps, then a single ordered copy."""

    def __init__(self, capacity: int, n_features: int, count: int):
        if capacity < 2:
            raise ValueError("WindowRing capacity must be >= 2")
        self.capacity = int(capacity)
        self.count = int(count)            # raw samples per window
        self.mean = np.zeros((self.capacity, n_features), np.float32)
        self.var = np.zeros((self.capacity, n_features), np.float32)
        self.label = np.full((self.capacity,), -1, np.int32)
        self.total = 0                     # windows ever pushed (monotone)

    def __len__(self):
        return min(self.total, self.capacity)

    def push(self, mean, var, label):
        h = self.total % self.capacity
        self.mean[h] = mean
        self.var[h] = var
        self.label[h] = label
        self.total += 1

    def push_batch(self, mean, var, label):
        b = len(label)
        if b > self.capacity:
            # the batch alone overfills the ring: the leading windows would
            # be evicted immediately, so only the tail is written
            off = b - self.capacity
            self.total += off
            mean, var, label = mean[off:], var[off:], label[off:]
            b = self.capacity
        idx = (self.total + np.arange(b)) % self.capacity
        self.mean[idx] = mean
        self.var[idx] = var
        self.label[idx] = label
        self.total += b

    def ordered(self, copy: bool = False):
        """Chronological (mean, var, label) of the retained windows.

        Until the ring wraps these are zero-copy views that later pushes
        mutate in place — fine for the synchronous consume-then-discard
        analysis cadence; pass ``copy=True`` to hold a stable snapshot."""
        n = len(self)
        if self.total <= self.capacity:
            m, v, l = self.mean[:n], self.var[:n], self.label[:n]
            return (m.copy(), v.copy(), l.copy()) if copy else (m, v, l)
        h = self.total % self.capacity
        return (np.concatenate([self.mean[h:], self.mean[:h]]),
                np.concatenate([self.var[h:], self.var[:h]]),
                np.concatenate([self.label[h:], self.label[:h]]))

    def series(self, copy: bool = False) -> "WindowSeries":
        m, v, _ = self.ordered(copy)
        return WindowSeries(m, v, self.count)

    def last_labels(self, k: int) -> np.ndarray:
        """Last ``k`` labels, chronological, front-padded with -1 when fewer
        than ``k`` windows have been pushed."""
        if k <= 0:
            return np.zeros((0,), np.int32)
        if k > self.capacity:
            raise ValueError(f"last_labels({k}) exceeds retention "
                             f"{self.capacity}")
        got = min(k, len(self))
        out = np.full((k,), -1, np.int32)
        if got:
            idx = (self.total - got + np.arange(got)) % self.capacity
            out[k - got:] = self.label[idx]
        return out

    # -- durable-session state (see KermitSession.checkpoint) ---------------

    def export_state(self) -> tuple[dict, dict]:
        """(meta, arrays) snapshot — raw slots plus the monotone ``total``,
        so a restored ring resumes at the exact same head position."""
        meta = {"capacity": self.capacity, "count": self.count,
                "n_features": int(self.mean.shape[1]), "total": self.total}
        arrays = {"mean": self.mean.copy(), "var": self.var.copy(),
                  "label": self.label.copy()}
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict) -> "WindowRing":
        ring = cls(int(meta["capacity"]), int(meta["n_features"]),
                   int(meta["count"]))
        ring.mean[:] = np.asarray(arrays["mean"], np.float32)
        ring.var[:] = np.asarray(arrays["var"], np.float32)
        ring.label[:] = np.asarray(arrays["label"], np.int32)
        ring.total = int(meta["total"])
        return ring


class BatchedWindowRing:
    """A ``WindowRing`` with a leading tenant axis: S lockstep rings stored
    as one struct-of-arrays block (``mean``/``var``: (S, capacity, F),
    ``label``: (S, capacity)).

    All tenants advance together — ``push_tick`` writes one window per
    tenant and bumps a single monotone ``total`` — so the head position,
    history length and eviction horizon are shared across the fleet.  Each
    per-tenant read (``ordered``/``series``/``last_labels`` row ``t``)
    reproduces exactly what a standalone ``WindowRing`` fed the same window
    sequence would return, which is what makes fleet decisions bit-comparable
    to scalar sessions (``tests/test_torch_fleet_*.py``)."""

    def __init__(self, tenants: int, capacity: int, n_features: int,
                 count: int):
        if tenants < 1:
            raise ValueError("BatchedWindowRing needs at least one tenant")
        if capacity < 2:
            raise ValueError("BatchedWindowRing capacity must be >= 2")
        self.tenants = int(tenants)
        self.capacity = int(capacity)
        self.count = int(count)            # raw samples per window
        self.mean = np.zeros((self.tenants, self.capacity, n_features),
                             np.float32)
        self.var = np.zeros((self.tenants, self.capacity, n_features),
                            np.float32)
        self.label = np.full((self.tenants, self.capacity), -1, np.int32)
        self.total = 0                     # lockstep ticks pushed (monotone)

    def __len__(self):
        return min(self.total, self.capacity)

    def push_tick(self, mean, var, label):
        """Write one window per tenant: mean/var (S, F), label (S,)."""
        h = self.total % self.capacity
        self.mean[:, h] = mean
        self.var[:, h] = var
        self.label[:, h] = label
        self.total += 1

    def last_window(self):
        """The most recent (mean, var) per tenant — the fleet's Welch
        carry, ((S, F), (S, F)).  Requires at least one pushed tick."""
        if self.total == 0:
            raise ValueError("BatchedWindowRing is empty")
        h = (self.total - 1) % self.capacity
        return self.mean[:, h], self.var[:, h]

    def last_labels(self, k: int) -> np.ndarray:
        """Last ``k`` labels per tenant, chronological, front-padded with -1
        — (S, k), the batched twin of ``WindowRing.last_labels``."""
        if k <= 0:
            return np.zeros((self.tenants, 0), np.int32)
        if k > self.capacity:
            raise ValueError(f"last_labels({k}) exceeds retention "
                             f"{self.capacity}")
        got = min(k, len(self))
        out = np.full((self.tenants, k), -1, np.int32)
        if got:
            idx = (self.total - got + np.arange(got)) % self.capacity
            out[:, k - got:] = self.label[:, idx]
        return out

    def ordered(self, tenant: int, copy: bool = False):
        """Chronological (mean, var, label) for one tenant — same view vs
        copy semantics as ``WindowRing.ordered``."""
        n = len(self)
        if self.total <= self.capacity:
            m = self.mean[tenant, :n]
            v = self.var[tenant, :n]
            l = self.label[tenant, :n]
            return (m.copy(), v.copy(), l.copy()) if copy else (m, v, l)
        h = self.total % self.capacity
        return (np.concatenate([self.mean[tenant, h:],
                                self.mean[tenant, :h]]),
                np.concatenate([self.var[tenant, h:], self.var[tenant, :h]]),
                np.concatenate([self.label[tenant, h:],
                                self.label[tenant, :h]]))

    def series(self, tenant: int, copy: bool = False) -> "WindowSeries":
        m, v, _ = self.ordered(tenant, copy)
        return WindowSeries(m, v, self.count)

    # -- durable state (mirrors WindowRing.export_state) ---------------------

    def export_state(self) -> tuple[dict, dict]:
        meta = {"tenants": self.tenants, "capacity": self.capacity,
                "count": self.count, "n_features": int(self.mean.shape[2]),
                "total": self.total}
        arrays = {"mean": self.mean.copy(), "var": self.var.copy(),
                  "label": self.label.copy()}
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict) -> "BatchedWindowRing":
        ring = cls(int(meta["tenants"]), int(meta["capacity"]),
                   int(meta["n_features"]), int(meta["count"]))
        ring.mean[:] = np.asarray(arrays["mean"], np.float32)
        ring.var[:] = np.asarray(arrays["var"], np.float32)
        ring.label[:] = np.asarray(arrays["label"], np.int32)
        ring.total = int(meta["total"])
        return ring


def make_windows(samples, window_size: int) -> WindowSeries:
    """samples: (N, F) raw telemetry -> floor(N/W) observation windows."""
    samples = np.asarray(samples, np.float32)
    n = (samples.shape[0] // window_size) * window_size
    s = samples[:n].reshape(-1, window_size, samples.shape[1])
    return WindowSeries(s.mean(1), s.var(1, ddof=1), window_size)


def rate_of_change(mean: np.ndarray) -> np.ndarray:
    """{A_t} -> {A'_t}: per-window feature deltas (TransitionClassifier
    features, training-pipeline step 5)."""
    d = np.diff(mean, axis=0, prepend=mean[:1])
    return d.astype(np.float32)
