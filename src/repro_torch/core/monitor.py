"""KWmon — the KERMIT Workload Monitor (on-line subsystem core).

Port of ``repro/core/monitor.py`` (the fused fast path).  Streams raw
telemetry, aggregates ``window_size`` samples into observation windows
O_t, runs the on-line pipeline (ChangeDetector -> WorkloadClassifier ->
WorkloadPredictor) and emits workload-context objects C_t carrying the
current label and the predicted labels at t+1 / t+5 / t+10.

Each ingested window batch runs ``_monitor_step``: Welch change detection,
forest classification and LSTM horizon prediction over the whole batch on
the monitor's device, with one host copy of the results per batch.
Batches are chunked to at most ``_MAX_BATCH`` windows and padded to the
reference's buckets.  Per-window state lives in a preallocated
``WindowRing``, contexts in a bounded deque, and JSONL context writes are
buffered and interval-flushed.  The reference's per-sample seed path
(``fast=False``) and the fleet step are queued in ROADMAP.
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.change_detector import ChangeDetector, stream_flags
from repro_torch.core.forest import forest_proba
from repro_torch.core.knowledge import UNKNOWN
from repro_torch.core.lstm import HORIZONS, forward_logits, one_hot
from repro_torch.core.windows import WindowRing, make_windows
from repro_torch.kernels.dispatch import resolve_device

# batching: chunks of at most _MAX_BATCH windows, padded up to the nearest
# bucket (the reference's compile-cache bound; here it keeps the shapes a
# device sees to a fixed few)
_MAX_BATCH = 128
_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# observability: fused-step executions ("dispatches").  This module dict is
# the process-wide aggregate; each KermitMonitor keeps its own ``stats``.
FASTPATH_STATS = {"dispatches": 0}


@dataclass
class WorkloadContext:
    window_id: int
    timestamp: float
    current_label: int                  # UNKNOWN until discovery catches up
    predicted: dict                     # {1: label, 5: label, 10: label}
    in_transition: bool
    features: list = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(asdict(self))


def _monitor_step(mean, var, prev_mean, prev_var, has_prev: bool,
                  hist_carry, log_len: int, clf_params, pred_params, mask, *,
                  n: int, alpha: float, quorum: float, depth: int,
                  pred_window: int, pred_classes: int):
    """Change-detect + classify + predict for a whole (B, F) window batch.

    ``hist_carry`` holds the last ``pred_window - 1`` emitted labels
    (front-padded with UNKNOWN) and ``log_len`` the total windows emitted
    before this batch, so per-row label histories and the history-length
    gate reconstruct exactly.  Absent classifier/predictor: None params."""
    B = mean.shape[0]
    dev = mean.device
    trans = stream_flags(prev_mean, prev_var, mean, var, has_prev, mask,
                         n=n, alpha=alpha, quorum=quorum)
    if clf_params is not None:
        raw = torch.argmax(forest_proba(clf_params, mean, depth), dim=-1)
        labels = torch.where(trans, UNKNOWN, raw.to(torch.int32))
    else:
        labels = torch.full((B,), UNKNOWN, dtype=torch.int32, device=dev)
    if pred_params is not None:
        W = pred_window
        full = torch.cat([hist_carry, labels])              # (W-1+B,)
        rows = torch.arange(B, device=dev)
        hist = full[rows[:, None] + torch.arange(W, device=dev)[None, :]]
        valid = (log_len + rows + 1 >= W) & torch.all(hist >= 0, dim=-1)
        with torch.no_grad():
            logits = forward_logits(pred_params,
                                    one_hot(hist.long(), pred_classes))
        preds = torch.stack([torch.where(
            valid, torch.argmax(logits[h], -1).to(torch.int32), UNKNOWN)
            for h in HORIZONS])                             # (3, B)
    else:
        preds = torch.full((len(HORIZONS), B), UNKNOWN, dtype=torch.int32,
                           device=dev)
    return trans, labels, preds


class KermitMonitor:
    def __init__(self, *, window_size: int = 32,
                 detector: Optional[ChangeDetector] = None,
                 classifier=None, predictor=None,
                 root: str | Path | None = None,
                 fast: bool = True,
                 retention: int = 4096,
                 ctx_retention: int = 4096,
                 ctx_flush_every: int = 64,
                 device=None):
        if not fast:
            raise NotImplementedError(
                "the per-sample seed monitor (fast=False) is not ported yet "
                "(ROADMAP queue A: legacy/seed paths)")
        self.device = resolve_device(device)
        self.window_size = window_size
        self.detector = detector or ChangeDetector(device=self.device)
        self.classifier = classifier      # RandomForest | None (untrained yet)
        self.predictor = predictor        # WorkloadPredictor | None
        self.fast = fast
        self.root = Path(root) if root else None
        self.stats = {"dispatches": 0}
        self._buf: list = []
        self._prev_window = None
        self._window_id = 0
        self._retention = int(retention)
        if predictor is not None and predictor.pc.window > self._retention:
            raise ValueError(
                f"predictor window {predictor.pc.window} exceeds monitor "
                f"retention {self._retention}")
        self._ring: Optional[WindowRing] = None   # width-lazy: see _ring_for
        self.contexts: deque = deque(maxlen=ctx_retention)
        self._ctx_buf: list[str] = []
        self._ctx_flush_every = max(int(ctx_flush_every), 1)
        if self.root is not None:
            (self.root / "tz").mkdir(parents=True, exist_ok=True)
            self._ctx_file = (self.root / "tz" / "context.jsonl").open("a")
        else:
            self._ctx_file = None

    # -- bounded-state views ---------------------------------------------------

    @property
    def pending_samples(self) -> int:
        """Raw samples buffered toward the next (incomplete) window."""
        return len(self._buf)

    @property
    def windows_emitted(self) -> int:
        """Total observation windows emitted so far."""
        return self._window_id

    def _ring_for(self, mean) -> WindowRing:
        """The window ring, created on first use with the stream's width."""
        if self._ring is None:
            self._ring = WindowRing(self._retention, int(np.shape(mean)[-1]),
                                    self.window_size)
        return self._ring

    @property
    def window_log(self):
        """Snapshot of the retained (mean, var) pairs, oldest first."""
        if self._ring is None:
            return []
        mean, var, _ = self._ring.ordered(copy=True)
        return list(zip(mean, var))

    @property
    def label_log(self) -> np.ndarray:
        """Snapshot of the retained per-window labels, oldest first."""
        if self._ring is None:
            return np.zeros((0,), np.int32)
        return self._ring.ordered(copy=True)[2]

    # -- streaming ingestion ---------------------------------------------------

    def ingest(self, sample) -> Optional[WorkloadContext]:
        """Feed one raw telemetry sample (F,); returns a context when a full
        observation window was completed."""
        self._buf.append(np.asarray(sample, np.float32))
        if len(self._buf) < self.window_size:
            return None
        arr = np.stack(self._buf)
        self._buf.clear()
        mean, var = arr.mean(0), arr.var(0, ddof=1)
        return self._emit_fast(mean[None], var[None])[0]

    def ingest_array(self, samples) -> list:
        """Feed a whole (N, F) telemetry batch: reshaped into windows up
        front, every chunk of windows runs one ``_monitor_step``."""
        samples = np.asarray(samples, np.float32)
        if self._buf:
            pending = np.stack(self._buf)
            self._buf.clear()
            samples = pending if samples.size == 0 \
                else np.concatenate([pending, samples])
        W = self.window_size
        n_win = samples.shape[0] // W
        out = []
        if n_win:
            ws = make_windows(samples, W)       # same math as the analyser
            out = self._emit_fast(ws.mean, ws.var)
        self._buf.extend(samples[n_win * W:])
        return out

    # -- fused batched path ----------------------------------------------------

    def _emit_fast(self, mean, var) -> list:
        out = []
        for i in range(0, len(mean), _MAX_BATCH):
            out.extend(self._emit_chunk(mean[i:i + _MAX_BATCH],
                                        var[i:i + _MAX_BATCH]))
        return out

    def _emit_chunk(self, mean, var) -> list:
        clf = self.classifier
        pred = self.predictor
        if (clf is not None and getattr(clf, "params", None) is None) or \
                (pred is not None and getattr(pred, "params", None) is None):
            raise TypeError(
                "the monitor needs a fitted classifier/predictor (the "
                "reference's per-window fallback for other models belongs "
                "to the seed path, not ported yet)")

        B = mean.shape[0]
        pad = next(b for b in _BUCKETS if b >= B) - B
        mean_p, var_p = mean, var
        if pad:
            mean_p = np.concatenate([mean, np.repeat(mean[-1:], pad, 0)])
            var_p = np.concatenate([var, np.repeat(var[-1:], pad, 0)])

        dev = self.device
        det = self.detector
        mask = None if det.feature_mask is None else torch.as_tensor(
            np.asarray(det.feature_mask, bool), device=dev)
        if self._prev_window is not None:
            prev_m, prev_v = self._prev_window[0], self._prev_window[1]
        else:
            prev_m = np.zeros((mean.shape[1],), np.float32)
            prev_v = prev_m

        ring = self._ring_for(mean[0])
        if pred is not None:
            pw = int(pred.pc.window)
            if pw > ring.capacity:
                raise ValueError(
                    f"predictor window {pw} exceeds monitor retention "
                    f"{ring.capacity}")
            hist_carry = ring.last_labels(pw - 1)
            pred_params, pcl = pred.params, int(pred.pc.n_classes)
        else:
            pw, pcl = 1, 1
            hist_carry = np.zeros((0,), np.int32)
            pred_params = None

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        FASTPATH_STATS["dispatches"] += 1
        self.stats["dispatches"] += 1
        trans, labels, preds = _monitor_step(
            f32(mean_p), f32(var_p), f32(prev_m), f32(prev_v),
            self._prev_window is not None,
            torch.as_tensor(hist_carry, dtype=torch.int32, device=dev),
            ring.total, None if clf is None else clf.params, pred_params,
            mask, n=self.window_size, alpha=det.alpha, quorum=det.quorum,
            depth=0 if clf is None else clf.fc.depth, pred_window=pw,
            pred_classes=pcl)
        trans = trans.cpu().numpy()[:B]
        labels = labels.cpu().numpy()[:B]
        preds = preds.cpu().numpy()[:, :B]

        self._prev_window = (mean[-1], var[-1], self.window_size)
        ring.push_batch(mean, var, labels)
        out = []
        for t in range(B):
            predicted = {h: int(preds[i, t]) for i, h in enumerate(HORIZONS)}
            out.append(self._new_context(int(labels[t]), predicted,
                                         bool(trans[t]), mean[t]))
        return out

    # -- context emission + buffered persistence -------------------------------

    def _new_context(self, label, predicted, in_trans, mean):
        ctx = WorkloadContext(
            window_id=self._window_id, timestamp=time.time(),
            current_label=label, predicted=predicted, in_transition=in_trans,
            features=[float(x) for x in mean])
        self._window_id += 1
        self.contexts.append(ctx)
        if self._ctx_file is not None:
            self._ctx_buf.append(ctx.to_json())
            if len(self._ctx_buf) >= self._ctx_flush_every:
                self.flush()
        return ctx

    def flush(self) -> None:
        """Drain buffered context lines to the JSONL file."""
        if self._ctx_buf and self._ctx_file is not None:
            self._ctx_file.write("\n".join(self._ctx_buf) + "\n")
            self._ctx_file.flush()
            self._ctx_buf.clear()

    def close(self) -> None:
        """Flush pending context lines and release the JSONL handle."""
        if self._ctx_file is not None:
            self.flush()
            self._ctx_file.close()
            self._ctx_file = None

    def __enter__(self) -> "KermitMonitor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        # durability net for callers that never close(): buffered tail
        # lines must not be lost
        try:
            self.close()
        except Exception:
            pass

    # -- batch access for the off-line subsystem ------------------------------

    def window_series(self, copy: bool = False):
        """Retained windows as a WindowSeries.  Zero-copy (live until the
        ring wraps) by default; ``copy=True`` holds a stable snapshot."""
        if self._ring is None or len(self._ring) == 0:
            return None
        return self._ring.series(copy)

    def latest_context(self) -> Optional[WorkloadContext]:
        return self.contexts[-1] if self.contexts else None
