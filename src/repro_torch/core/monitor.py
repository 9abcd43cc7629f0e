"""KWmon — the KERMIT Workload Monitor (on-line subsystem core).

Port of ``repro/core/monitor.py``.  Streams raw telemetry, aggregates
``window_size`` samples into observation windows O_t, runs the on-line
pipeline (ChangeDetector -> WorkloadClassifier -> WorkloadPredictor) and
emits workload-context objects C_t carrying the current label and the
predicted labels at t+1 / t+5 / t+10.  Two paths:

* ``fast=True`` (default) — each ingested window batch runs
  ``_monitor_step``: Welch change detection, forest classification and
  LSTM horizon prediction over the whole batch on the monitor's device,
  with one host copy of the results per batch.  Batches are chunked to at
  most ``_MAX_BATCH`` windows and padded to the reference's buckets.
* ``fast=False`` — the seed per-sample path (``_emit``, one window at a
  time, three host round-trips each), the seed loop's baseline.  The fast
  path falls back to it per window for duck-typed models.

Both emit identical labels, flags and predictions.  Per-window state
lives in a preallocated ``WindowRing``, contexts in a bounded deque, and
JSONL context writes are buffered and interval-flushed.

``fleet_monitor_step`` is the fleet's step: ``torch.func.vmap`` of the
same ``_monitor_step`` over a leading tenant axis, one window per tenant,
with the fallback to a per-tenant loop switched off (an op without a
batching rule raises instead of launching S kernels).
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from functools import partial
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


@contextmanager
def _no_vmap_fallback():
    """Make ``torch.func.vmap`` raise on an op with no batching rule,
    where it would otherwise run a Python loop over the batch with only a
    warning."""
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)


def fleet_monitor_step(mean, var, prev_mean, prev_var, has_prev: bool,
                       hist_carry, log_len: int, clf_params, pred_params,
                       mask, *, n: int, alpha: float, quorum: float,
                       depth: int, pred_window: int, pred_classes: int):
    """The batched-leading-axis twin of ``_monitor_step``: one window for
    each of S tenants in one step.

    ``mean``/``var`` are (S, 1, F) — each tenant contributes a B=1 batch —
    ``prev_mean``/``prev_var`` (S, F) per-tenant Welch carries and
    ``hist_carry`` (S, pred_window - 1) per-tenant label histories.
    ``has_prev``/``log_len`` are shared (fleet tenants advance in
    lockstep), as is ``mask``.  Classifier/predictor params are either None
    (shared absence) or dicts of tensors stacked along a leading tenant
    axis; tenants whose models differ in shape are separate cohorts
    (``KermitFleet`` groups them).

    ``vmap`` of the very same ``_monitor_step`` body keeps each tenant's
    arithmetic that of a scalar monitor driven one window at a time.
    Returns trans (S, 1), labels (S, 1), preds (S, 3, 1)."""
    fn = partial(_monitor_step, n=n, alpha=alpha, quorum=quorum, depth=depth,
                 pred_window=pred_window, pred_classes=pred_classes)
    dims = (0, 0, 0, 0, None, 0, None,
            None if clf_params is None else 0,
            None if pred_params is None else 0,
            None)
    with _no_vmap_fallback():
        return torch.func.vmap(fn, in_dims=dims)(
            mean, var, prev_mean, prev_var, has_prev, hist_carry, log_len,
            clf_params, pred_params, mask)


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
        if self.fast:
            return self._emit_fast(mean[None], var[None])[0]
        return self._emit(mean, var)

    def ingest_array(self, samples) -> list:
        """Feed a whole (N, F) telemetry batch.  On the fast path it is
        reshaped into windows up front and every chunk of windows runs one
        ``_monitor_step``; the seed path loops ``ingest`` per sample."""
        samples = np.asarray(samples, np.float32)
        if not self.fast:
            out = []
            for s in samples:
                c = self.ingest(s)
                if c is not None:
                    out.append(c)
            return out
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

    # -- seed per-window path (baseline / parity oracle) -----------------------

    def _emit(self, mean, var) -> WorkloadContext:
        n = self.window_size
        in_trans = False
        if self._prev_window is not None:
            in_trans = self.detector.online(self._prev_window, (mean, var, n))
        self._prev_window = (mean, var, n)

        label = UNKNOWN
        if self.classifier is not None and not in_trans:
            label = int(self.classifier.predict(mean[None])[0])
        ring = self._ring_for(mean)
        ring.push(mean, var, label)

        predicted = {h: UNKNOWN for h in HORIZONS}
        if self.predictor is not None and ring.total >= \
                self.predictor.pc.window and label != UNKNOWN:
            hist = ring.last_labels(self.predictor.pc.window)
            if (hist >= 0).all():
                p = self.predictor.predict(hist)
                predicted = {h: int(v[0]) for h, v in p.items()}
        return self._new_context(label, predicted, bool(in_trans), mean)

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
        if (clf is not None and (getattr(clf, "params", None) is None
                                 or not hasattr(clf, "fc"))) or \
                (pred is not None and not hasattr(pred, "params")):
            # duck-typed classifier/predictor (no fitted tensor params): the
            # batched step cannot absorb them — per-window seed fallback
            return [self._emit(m, v) for m, v in zip(mean, var)]

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
        if pred is not None and pred.params is not None:
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

    # -- durable-session state (see KermitSession.checkpoint) ------------------

    def export_state(self) -> tuple[dict, dict]:
        """(meta, arrays) snapshot of every mutable Monitor field that shapes
        decisions: the pending sample buffer, the Welch carry window, the
        window counter, the WindowRing, and the retained contexts.  The
        attached classifier/predictor are snapshotted by their own owners
        (the analyser) — the monitor only borrows references."""
        meta: dict = {"window_id": self._window_id,
                      "has_prev": self._prev_window is not None,
                      "contexts": [asdict(c) for c in self.contexts]}
        arrays: dict = {}
        if self._buf:
            arrays["buf"] = np.stack(self._buf).astype(np.float32)
        if self._prev_window is not None:
            m, v, n = self._prev_window
            arrays["prev_mean"] = np.asarray(m, np.float32)
            arrays["prev_var"] = np.asarray(v, np.float32)
            meta["prev_n"] = int(n)
        if self._ring is not None:
            rmeta, rarr = self._ring.export_state()
            meta["ring"] = rmeta
            arrays.update({f"ring_{k}": v for k, v in rarr.items()})
        return meta, arrays

    def restore_state(self, meta: dict, arrays: dict) -> None:
        self._window_id = int(meta["window_id"])
        self._buf = [np.asarray(s, np.float32) for s in arrays["buf"]] \
            if "buf" in arrays else []
        if meta.get("has_prev"):
            self._prev_window = (np.asarray(arrays["prev_mean"], np.float32),
                                 np.asarray(arrays["prev_var"], np.float32),
                                 int(meta["prev_n"]))
        else:
            self._prev_window = None
        self._ring = WindowRing.from_state(
            meta["ring"],
            {k[len("ring_"):]: v for k, v in arrays.items()
             if k.startswith("ring_")}) if "ring" in meta else None
        self.contexts.clear()
        for d in meta.get("contexts", []):
            d = dict(d)
            # JSON coerces the horizon keys to strings; restore int keys
            d["predicted"] = {int(k): int(v)
                              for k, v in d["predicted"].items()}
            self.contexts.append(WorkloadContext(**d))

    # -- batch access for the off-line subsystem ------------------------------

    def window_series(self, copy: bool = False):
        """Retained windows as a WindowSeries.  Zero-copy (live until the
        ring wraps) by default; ``copy=True`` holds a stable snapshot."""
        if self._ring is None or len(self._ring) == 0:
            return None
        return self._ring.series(copy)

    def latest_context(self) -> Optional[WorkloadContext]:
        return self.contexts[-1] if self.contexts else None
