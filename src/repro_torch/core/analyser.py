"""KWanl — the off-line (batch) analysis subsystem.

Port of ``repro/core/analyser.py`` (the fast path).  Discovery runs
DBSCAN through the hand-written neighbour kernel on the card; forest and
predictor training run on the analyser's device.  Reported seconds end in
a device synchronize, so they include the work and not just its launch.

Implements paper Algorithm 2 + the automated training pipeline (§7):
  1. ChangeDetector.batch flags transition windows
  2. transitions are filtered out; DBSCAN discovers workload clusters
  3. clusters are characterized and matched against WorkloadDB (Welch);
     matches update characterizations + drift flags, novelties get fresh
     integer labels — labelling needs no human
  4. training sets are generated: windows->labels (WorkloadClassifier),
     rate-of-change transition windows (TransitionClassifier), synthesized
     hybrids (ZSL), label sequences (WorkloadPredictor)
  5. classifiers are (re)trained
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.change_detector import ChangeDetector
from repro_torch.core.characterize import characterize
from repro_torch.core.dbscan import dbscan
from repro_torch.core.forest import ForestConfig, RandomForest
from repro_torch.core.knowledge import WorkloadDB
from repro_torch.core.lstm import HORIZONS, PredictorConfig, WorkloadPredictor
from repro_torch.core.synthesizer import sample_pure, synthesize
from repro_torch.core.windows import WindowSeries, rate_of_change
from repro_torch.kernels.dispatch import resolve_device


# fast-path training bounds: bootstrap draws per tree, predictor training
# subsample / batch / width (see ROADMAP "analysis-path latency budget")
_FAST_MAX_SAMPLES = 768
_FAST_PREDICTOR_SAMPLES = 768
_FAST_PREDICTOR_BATCH = 256
_FAST_PREDICTOR_HIDDEN = 32


@dataclass
class AnalysisReport:
    n_windows: int = 0
    n_transition_windows: int = 0
    clusters: int = 0
    new_labels: list = field(default_factory=list)
    matched_labels: list = field(default_factory=list)
    drifted_labels: list = field(default_factory=list)
    window_labels: Optional[np.ndarray] = None   # per-window DB label (-1 noise)
    discover_seconds: float = 0.0                # A-phase latency accounting
    train_seconds: float = 0.0
    dbscan_seconds: float = 0.0                  # parts of the two above
    forest_seconds: float = 0.0                  # both forests
    predictor_seconds: float = 0.0

    @property
    def analysis_seconds(self) -> float:
        return self.discover_seconds + self.train_seconds


class KermitAnalyser:
    """The fast analysis path: streaming DBSCAN (the CUDA kernel on the
    card, its plain version on the CPU), batched forest training and the
    early-stopping predictor loop.  The reference's seed path
    (``fast=False``) is queued in ROADMAP."""

    def __init__(self, db: WorkloadDB, *,
                 detector: Optional[ChangeDetector] = None,
                 dbscan_eps: float = 0.35, dbscan_min_pts: int = 4,
                 max_classes: int = 64,
                 dbscan_impl: str = "auto", fast: bool = True,
                 device=None):
        if not fast:
            raise NotImplementedError(
                "the seed analysis path (fast=False) is not ported yet "
                "(ROADMAP queue A: legacy/seed paths)")
        self.device = resolve_device(device)
        self.db = db
        self.detector = detector or ChangeDetector(device=self.device)
        self.eps = dbscan_eps
        self.min_pts = dbscan_min_pts
        self.max_classes = max_classes
        self.fast = fast
        self.dbscan_impl = dbscan_impl
        self.classifier: Optional[RandomForest] = None
        self.transition_classifier: Optional[RandomForest] = None
        self.predictor: Optional[WorkloadPredictor] = None

    # -- Algorithm 2 ----------------------------------------------------------

    def discover(self, ws: WindowSeries) -> AnalysisReport:
        t0 = time.perf_counter()
        rep = AnalysisReport(n_windows=len(ws))
        trans = self.detector.batch(ws)
        rep.n_transition_windows = int(trans.sum())
        steady_idx = np.where(~trans)[0]
        if steady_idx.size == 0:
            rep.discover_seconds = time.perf_counter() - t0
            return rep
        X = ws.mean[steady_idx]
        t1 = time.perf_counter()
        labels = dbscan(X, self.eps, self.min_pts, impl=self.dbscan_impl,
                        device=self.device)
        rep.dbscan_seconds = time.perf_counter() - t1   # labels are on the host
        rep.clusters = int(labels.max() + 1) if labels.size else 0

        window_labels = np.full(len(ws), -1, np.int64)
        for c in range(rep.clusters):
            members = steady_idx[labels == c]
            char = characterize(ws.mean[members])
            match = self.db.find_match(char)
            if match is not None:
                drift = self.db.observe(match, char)
                rep.matched_labels.append(match)
                if drift:
                    rep.drifted_labels.append(match)
                window_labels[members] = match
            else:
                new = self.db.insert(char)
                rep.new_labels.append(new)
                window_labels[members] = new
        rep.window_labels = window_labels
        # convergence/bound maintenance: classes whose characterizations have
        # converged merge (newer label aliased onto older), over-bound stores
        # evict.  Remap freshly-labelled windows by membership — aliases
        # resolve to the survivor, labels the DB no longer holds (evicted by
        # this pass OR by an insert earlier in the loop) drop to noise — so
        # the training set never references a label the DB cannot resolve.
        self.db.consolidate()
        for u in np.unique(window_labels):
            if u < 0:
                continue
            r = self.db.resolve(int(u))
            if r not in self.db.records:
                r = -1
            if r != u:
                window_labels[window_labels == u] = r
        self.db.save()
        rep.discover_seconds = time.perf_counter() - t0
        return rep

    # -- training pipeline (§7.2 steps 1-9) ------------------------------------

    def train(self, ws: WindowSeries, rep: AnalysisReport, *,
              synthesize_hybrids: bool = True, zsl_k: int = 2, seed: int = 0,
              predictor_cfg: Optional[PredictorConfig] = None,
              forest_cfg: Optional[ForestConfig] = None):
        t0 = time.perf_counter()
        wl = rep.window_labels
        if wl is None or (wl >= 0).sum() == 0:
            return self
        mask = wl >= 0
        X = ws.mean[mask]
        y = wl[mask]

        # step 7: ZSL synthesis from pure characterizations (k-way mixtures
        # up to ``zsl_k`` concurrent archetypes).  One synthetic WorkloadDB
        # record per combination, ever: combos the knowledge base already
        # anticipates reuse their stored label (prototype refreshed) instead
        # of inserting a duplicate on every analysis run.
        if synthesize_hybrids:
            pure = self.db.pure_characterizations()
            Xs, ys, hybrids = synthesize(
                pure, n_per_class=100, seed=seed,
                next_label=self.db._next_label, k=zsl_k)
            for h in hybrids:
                existing = self.db.find_synthetic(h.pair)
                if existing is not None and existing != h.label:
                    self.db.refresh_synthetic(existing, h.prototype)
                    ys[ys == h.label] = existing
                elif len(self.db.records) < self.db.max_records:
                    self.db.insert(h.prototype, is_synthetic=True,
                                   pair=h.pair, label=h.label)
                # a full store skips the remaining anticipations rather
                # than churning labels through eviction every run; their
                # training rows are dropped by the membership filter below
            Xb, yb = sample_pure(pure, n_per_class=100, seed=seed + 1)
            if Xs.size:
                # a full store may have evicted an earlier hybrid while
                # inserting a later one; never train on unresolvable labels
                present = np.isin(ys, np.asarray(self.db.labels()))
                X = np.concatenate([X, Xb, Xs[present]])
                y = np.concatenate([y, yb, ys[present]])

        n_classes = int(max(self.db.labels(), default=0)) + 1
        max_samples = _FAST_MAX_SAMPLES
        fc = forest_cfg or ForestConfig(n_trees=24, depth=6,
                                        n_classes=min(n_classes,
                                                      self.max_classes),
                                        max_samples=max_samples)
        t1 = time.perf_counter()
        self.classifier = RandomForest(fc, device=self.device).fit(
            X, y, seed=seed)

        # transition classifier on rate-of-change features
        roc = rate_of_change(ws.mean)
        ty = (wl < 0).astype(np.int64)       # 1 = transition/noise window
        tfc = ForestConfig(n_trees=16, depth=5, n_classes=2,
                           max_samples=max_samples)
        self.transition_classifier = RandomForest(
            tfc, device=self.device).fit(roc, ty, seed=seed)
        rep.forest_seconds = self._since(t1)

        # predictor on the label sequence (steady windows carry labels;
        # transitions inherit the previous label for sequence continuity) —
        # forward-fill vectorized via a running max of labelled indices
        idx = np.where(wl >= 0, np.arange(len(wl)), -1)
        np.maximum.accumulate(idx, out=idx)
        first = wl[wl >= 0]
        seq = np.where(idx >= 0, wl[np.maximum(idx, 0)],
                       first[0] if first.size else 0)
        if predictor_cfg is not None:
            pc = predictor_cfg
        else:
            # bounded retraining: a uniform subsample of history windows
            # caps per-analysis compute regardless of N, and a larger batch
            # + loss-plateau early stopping keeps the compiled train loop
            # to a handful of epochs
            n_samples = min(len(seq) - PredictorConfig.window - max(HORIZONS),
                            _FAST_PREDICTOR_SAMPLES)
            pc = PredictorConfig(
                n_classes=max(int(seq.max()) + 1, 2), epochs=30,
                hidden=_FAST_PREDICTOR_HIDDEN, lr=1e-2,
                batch=max(16, min(_FAST_PREDICTOR_BATCH, n_samples)),
                early_stop_tol=1e-2, patience=2, target_loss=0.15,
                max_train_samples=_FAST_PREDICTOR_SAMPLES)
        t1 = time.perf_counter()
        try:
            self.predictor = WorkloadPredictor(pc, device=self.device).fit(
                seq, seed=seed)
        except ValueError:
            self.predictor = None            # sequence too short
        rep.predictor_seconds = self._since(t1)
        self.db.save()
        rep.train_seconds = self._since(t0)
        return self

    def _since(self, t0: float) -> float:
        """Seconds since ``t0``, after the device has finished the work
        (CUDA launches are asynchronous), so reported latency is honest."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def run(self, ws: WindowSeries, **kw) -> AnalysisReport:
        rep = self.discover(ws)
        self.train(ws, rep, **kw)
        return rep
