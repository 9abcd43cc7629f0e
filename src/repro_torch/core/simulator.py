"""Workload simulator: ground-truth telemetry streams for evaluating the

Port of ``repro/core/simulator.py`` (numpy; copied, same
``np.random.default_rng`` calls, so traces are bit-identical).
KERMIT pipeline (the paper's role for HiBench/Spark benchmark runs).

Pure archetypes are TPU-runtime phases with distinct telemetry signatures
(the analogue of Hadoop map / reduce / SQL scan / ML-train container
patterns). ``generate`` renders a schedule of (archetype, n_windows) segments
joined by linear-ramp transitions, returning raw samples plus ground-truth
window labels and transition flags; ``generate_hybrid`` renders convex blends
of k >= 2 archetypes (multi-user windows) for the ZSL evaluation — Beta(2,2)
per-sample weights for pairs (seed-identical), Dirichlet(2,...,2) beyond.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.windows import NUM_FEATURES, FEATURES, make_windows

# feature means per archetype (see windows.FEATURES for the order)
_A = {
    #                st   tok  mfu  hbm  col  hw   mem  gn   ld   imb  occ  sl   bl   dec  rc   io
    "dense_train":  [.30, .80, .45, .55, .20, .05, .75, .60, .30, .00, .00, .60, .80, .00, .35, .50],
    "moe_train":    [.45, .60, .30, .50, .45, .05, .85, .70, .35, .45, .00, .60, .80, .00, .35, .50],
    "long_prefill": [.80, .40, .55, .70, .15, .02, .90, .00, .00, .00, .60, .95, .30, .00, .10, .30],
    "decode_serve": [.05, .10, .06, .85, .10, .01, .60, .00, .00, .00, .80, .95, .60, .95, .00, .05],
    "ssm_train":    [.25, .90, .40, .65, .15, .05, .65, .55, .30, .00, .00, .60, .80, .00, .30, .55],
    "eval_loop":    [.15, .70, .35, .50, .15, .20, .55, .00, .05, .00, .00, .60, .70, .00, .00, .70],
    "ingest_bound": [.50, .25, .10, .20, .05, .80, .40, .50, .30, .00, .00, .60, .80, .00, .35, .95],
}
_STD_FRAC = 0.06       # per-feature noise scale

ARCHETYPES = sorted(_A)


def archetype_stats(name: str):
    m = np.asarray(_A[name], np.float32)
    return m, np.maximum(_STD_FRAC, 0.08 * m).astype(np.float32)


@dataclass
class SimResult:
    samples: np.ndarray            # (N, F) raw telemetry
    window_labels: np.ndarray      # (n_windows,) ground-truth archetype index
    window_transition: np.ndarray  # (n_windows,) bool
    window_size: int
    schedule: list                 # [(archetype, n_windows)...]

    @property
    def windows(self):
        return make_windows(self.samples, self.window_size)


def generate(schedule, *, window_size: int = 32, transition_windows: int = 2,
             seed: int = 0, drift: float = 0.0) -> SimResult:
    """schedule: [(archetype_name, n_windows), ...]."""
    rng = np.random.default_rng(seed)
    samples, labels, trans = [], [], []
    prev_mean = None
    for seg_i, (name, n_win) in enumerate(schedule):
        mean, std = archetype_stats(name)
        if drift:
            mean = mean * (1.0 + drift * seg_i)
        if prev_mean is not None and transition_windows:
            n_t = transition_windows * window_size
            a = np.linspace(0, 1, n_t, dtype=np.float32)[:, None]
            ramp = (1 - a) * prev_mean + a * mean
            samples.append(ramp + rng.normal(size=(n_t, NUM_FEATURES)) * std)
            labels += [-2] * transition_windows           # transition marker
            trans += [True] * transition_windows
        n = n_win * window_size
        samples.append(mean + rng.normal(size=(n, NUM_FEATURES)) * std)
        labels += [ARCHETYPES.index(name)] * n_win
        trans += [False] * n_win
        prev_mean = mean
    return SimResult(np.concatenate(samples).astype(np.float32),
                     np.asarray(labels), np.asarray(trans), window_size,
                     list(schedule))


def generate_hybrid(pair, *, n_windows: int = 40, window_size: int = 32,
                    seed: int = 0, alpha: float | None = None,
                    weights=None):
    """Multi-user hybrid stream: convex blend of k >= 2 archetypes.

    ``pair`` is a tuple of archetype names.  Two archetypes with no explicit
    ``weights`` keep the original Beta(2,2) per-sample blend (bit-identical
    to the seed implementation for the same ``seed``); three or more draw
    per-sample mixture weights from Dirichlet(2,...,2), matching the
    synthesizer's k-way class-descriptor model so multi-user scenarios with
    3+ concurrent archetypes can be generated and ZSL-matched end to end.
    ``weights`` pins the blend to fixed mixture proportions instead.
    """
    names = tuple(pair)
    if alpha is not None and (len(names) != 2 or weights is not None):
        raise ValueError(
            "alpha= pins a 2-way Beta blend; use weights= for k-way "
            "mixtures or fixed proportions")
    rng = np.random.default_rng(seed)
    n = n_windows * window_size
    if len(names) == 2 and weights is None:
        m1, s1 = archetype_stats(names[0])
        m2, s2 = archetype_stats(names[1])
        if alpha is None:
            a = rng.beta(2, 2, (n, 1)).astype(np.float32)
        else:
            a = np.full((n, 1), alpha, np.float32)
        mean = a * m1 + (1 - a) * m2
        std = np.sqrt(a ** 2 * s1 ** 2 + (1 - a) ** 2 * s2 ** 2)
        return (mean + rng.normal(size=mean.shape) * std).astype(np.float32)
    stats = [archetype_stats(name) for name in names]
    M = np.stack([m for m, _ in stats]).astype(np.float64)   # (k, F)
    S = np.stack([s for _, s in stats]).astype(np.float64)
    if weights is None:
        w = rng.dirichlet(np.full(len(names), 2.0), size=n)  # (n, k)
    else:
        w = np.asarray(weights, np.float64)
        w = np.tile(w / w.sum(), (n, 1))
    mean = w @ M
    std = np.sqrt((w ** 2) @ (S ** 2))
    return (mean + rng.normal(size=mean.shape) * std).astype(np.float32)


def inject_feature_shift(samples, window_size: int, at_window: int,
                         delta: dict, duration: int | None = None):
    """Additively shift named telemetry features from ``at_window`` on (for
    ``duration`` windows; None = through the end) — how the chaos harness
    renders a fault's telemetry signature (e.g. a straggler's step-time /
    collective-stall shift) into a simulated stream so the Monitor's Welch
    detector sees it as a workload transition.  Returns a shifted copy.

    ``delta`` maps feature names (``windows.FEATURES``) to additive shifts
    of the normalized telemetry value.
    """
    out = np.array(samples, np.float32)
    lo = at_window * window_size
    hi = len(out) if duration is None else lo + duration * window_size
    for name, shift in delta.items():
        out[lo:hi, FEATURES.index(name)] += np.float32(shift)
    return out


def random_schedule(n_segments: int, *, min_len=6, max_len=20, seed=0,
                    subset=None):
    rng = np.random.default_rng(seed)
    names = list(subset or ARCHETYPES)
    out = []
    prev = None
    for _ in range(n_segments):
        name = names[rng.integers(len(names))]
        while name == prev and len(names) > 1:
            name = names[rng.integers(len(names))]
        out.append((name, int(rng.integers(min_len, max_len))))
        prev = name
    return out
