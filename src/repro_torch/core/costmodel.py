"""Model-based Plan: learned cost surface + knob significance analysis.

Port of ``repro/core/costmodel.py``.  The significance analysis is host
Python, copied.  The cost surface is the reference's tiny MLP (tanh hidden
layers, one linear output) in plain PyTorch on the caller's device, trained
by the same full-batch Adam loop: ``epochs`` steps over the canonicalized
rows, zero-weight padded to the reference's ``_bucket`` sizes so both
packages sum over the same rows.  It is a few kilobytes of parameters, so
it runs as plain tensor ops, not as a kernel.

The initial parameters come from one draw function, ``_init_draws`` (a CPU
``torch.Generator``, so the card and the CPU draw the same numbers); tests
replace it with the reference's ``_init_params``.  The Adam loop sums in
PyTorch's order, not XLA's, so a fitted model's predictions agree with the
reference's to float noise (``tests/test_torch_costmodel.py`` states the
tolerance), not bit for bit.

Two estimators over stored ``SearchResult.trace`` rows (``(config dict,
measured cost)`` pairs — WorkloadDB keeps a bounded per-record history of
them), both keyed to the ``configs/base`` struct-of-arrays encoding:

* ``knob_sensitivity`` — Tuneful-style significance analysis (Fekry et
  al.): per-knob main effects measured from the trace, so searches can pin
  the knobs that demonstrably do not matter for a workload class and sweep
  only the significant subspace.
* ``CostModel`` — a small MLP (Zaouk et al.-style) trained on the same
  rows, used by ``Explorer.model_ranked_exhaustive`` to pre-rank the grid
  so a budgeted probe finds the winner in the first slices.

Determinism contract: ``fit`` canonicalizes its training set — rows dedupe
onto encoded feature keys, duplicate costs average in sorted order, keys
sort lexicographically — so train/predict is bit-identical under ANY
permutation of the trace.  ``knob_sensitivity`` rankings are invariant
under positive rescaling of the costs (main effects scale uniformly).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import encode_tunable_values, tunables_to_arrays
from repro_torch.kernels.dispatch import resolve_device

# ---------------------------------------------------------------------------
# Significance analysis (Plan-phase subspace pruning)
# ---------------------------------------------------------------------------


def knob_sensitivity(trace, space: dict) -> dict:
    """Per-knob main effect from measured trace rows: the spread (max - min)
    of per-value mean costs.  Knobs observed at fewer than two distinct
    values are OMITTED — their effect is unknown, and ``significant_knobs``
    never prunes what the trace cannot rank.  Duplicate costs are averaged
    in sorted order so the result is independent of trace ordering."""
    groups: dict[str, dict] = {k: {} for k in space}
    for cfg, cost in trace:
        for k in space:
            if k in cfg:
                groups[k].setdefault(_value_key(cfg[k]), []).append(
                    float(cost))
    sens = {}
    for k, by_val in groups.items():
        if len(by_val) < 2:
            continue
        means = [math.fsum(sorted(v)) / len(v) for v in by_val.values()]
        sens[k] = max(means) - min(means)
    return sens


def significant_knobs(sens: dict, space: dict, threshold: float) -> list:
    """Knobs worth searching: main effect >= ``threshold`` * the largest
    effect, plus every knob ``sens`` could not rank (missing = unknown =
    keep).  ``threshold <= 0`` disables pruning; the top-effect knob is
    always kept.  Returned in ``space`` order."""
    if threshold <= 0 or not sens:
        return list(space)
    cut = threshold * max(sens.values())
    top = max(sens, key=lambda k: (sens[k], k))
    return [k for k in space
            if k == top or k not in sens or sens[k] >= cut]


def _value_key(v):
    # bool is an int subclass: True/1 must not collide across knobs that
    # genuinely mix the types
    return (type(v).__name__, v)


# ---------------------------------------------------------------------------
# MLP cost surface
# ---------------------------------------------------------------------------


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _init_draws(seed: int, sizes) -> list:
    """Initial [(W, b)] per layer as CPU float32 tensors: W ~ N(0, 1/fan_in),
    b = 0."""
    g = torch.Generator().manual_seed(int(seed))
    return [(torch.randn((fan_in, fan_out), generator=g)
             / float(np.sqrt(fan_in)), torch.zeros(fan_out))
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:])]


def _forward(params, X):
    h = X
    for W, b in params[:-1]:
        h = torch.tanh(h @ W + b)
    W, b = params[-1]
    return (h @ W + b)[:, 0]


def _fit_params(params, X, y, w, *, epochs: int, lr: float) -> list:
    """Full-batch Adam for ``epochs`` steps: the reference's update
    (β = 0.9, 0.999, ε = 1e-8, bias-corrected) on the weighted mean squared
    error.  Rows are bucket-padded with zero weights."""
    leaves = [t.detach().clone() for W_b in params for t in W_b]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    denom = torch.clamp_min(w.sum(), 1.0)
    steps = np.arange(1.0, epochs + 1.0, dtype=np.float32)
    bc1 = np.float32(1.0) - np.float32(0.9) ** steps
    bc2 = np.float32(1.0) - np.float32(0.999) ** steps
    for t in range(epochs):
        ps = [p.requires_grad_(True) for p in leaves]
        pred = _forward(list(zip(ps[0::2], ps[1::2])), X)
        loss = torch.sum(w * torch.square(pred - y)) / denom
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            new = []
            for i, (p, g) in enumerate(zip(ps, grads)):
                m[i] = 0.9 * m[i] + 0.1 * g
                v[i] = 0.999 * v[i] + 0.001 * g * g
                mh = m[i] / float(bc1[t])
                vh = v[i] / float(bc2[t])
                new.append(p - lr * mh / (torch.sqrt(vh) + 1e-8))
        leaves = new
    return [(W.detach(), b.detach())
            for W, b in zip(leaves[0::2], leaves[1::2])]


class CostModel:
    """Cost surface over one search space (knob -> candidate values).

    Features per candidate: one-hot of the candidate index per knob plus a
    normalized-position scalar (one-hot captures non-monotone effects, the
    scalar helps the tiny net interpolate ordered numeric knobs).  Off-grid
    values in trace rows snap to the nearest encoded candidate — the same
    projection ``KermitPlugin._snap_to_space`` applies to stored configs.
    Targets are standardized from the canonicalized training set, so
    predictions come back in real cost units.  ``device``: where the MLP
    trains and predicts (None: CUDA)."""

    def __init__(self, space: dict, *, hidden=(32, 16), epochs: int = 300,
                 lr: float = 0.01, seed: int = 0, device=None):
        if not space:
            raise ValueError("CostModel needs a non-empty search space")
        self.space = {k: list(v) for k, v in space.items()}
        self.hidden = tuple(int(h) for h in hidden)
        self.epochs = int(epochs)
        self.lr = float(lr)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._enc = {k: np.asarray(encode_tunable_values(k, v), np.float64)
                     for k, v in self.space.items()}
        self.dim = sum(len(v) + 1 for v in self.space.values())
        self.params = None
        self._y_mean, self._y_std = 0.0, 1.0
        self.n_train = 0

    @property
    def trained(self) -> bool:
        return self.params is not None

    # -- encoding ------------------------------------------------------------

    def _index_of(self, knob: str, value) -> int:
        enc = np.asarray(encode_tunable_values(knob, [value]), np.float64)
        return int(np.abs(self._enc[knob] - enc[0]).argmin())

    def _features_from_idx(self, idx: dict) -> np.ndarray:
        n = len(next(iter(idx.values())))
        X = np.zeros((n, self.dim), np.float32)
        col = 0
        for k, values in self.space.items():
            m = len(values)
            X[np.arange(n), col + idx[k]] = 1.0
            X[:, col + m] = idx[k] / max(m - 1, 1)
            col += m + 1
        return X

    def _canonical_rows(self, trace):
        """(sorted feature keys, order-independent mean costs)."""
        by_key: dict[tuple, list] = {}
        for cfg, cost in trace:
            if not all(k in cfg for k in self.space):
                continue
            key = tuple(self._index_of(k, cfg[k]) for k in self.space)
            by_key.setdefault(key, []).append(float(cost))
        keys = sorted(by_key)
        y = np.array([math.fsum(sorted(by_key[k])) / len(by_key[k])
                      for k in keys], np.float64)
        return keys, y

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -- train / predict -----------------------------------------------------

    def fit(self, trace) -> "CostModel":
        keys, y = self._canonical_rows(trace)
        if not keys:
            raise ValueError("no usable trace rows cover the search space")
        idx = {k: np.array([key[j] for key in keys], np.int64)
               for j, k in enumerate(self.space)}
        X = self._features_from_idx(idx)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        n, b = len(keys), _bucket(len(keys))
        Xp = np.zeros((b, self.dim), np.float32)
        Xp[:n] = X
        yp = np.zeros(b, np.float32)
        yp[:n] = yn
        w = np.zeros(b, np.float32)
        w[:n] = 1.0
        init = [(self._tensor(W), self._tensor(bb)) for W, bb in
                _init_draws(self.seed, (self.dim, *self.hidden, 1))]
        self.params = _fit_params(init, self._tensor(Xp), self._tensor(yp),
                                  self._tensor(w), epochs=self.epochs,
                                  lr=self.lr)
        self.n_train = n
        return self

    def predict_arrays(self, soa: dict) -> np.ndarray:
        """Predicted costs for a struct-of-arrays candidate batch (the
        ``tunables_to_arrays`` / ``Explorer._grid_chunks`` encoding)."""
        if self.params is None:
            raise RuntimeError("CostModel.predict before fit")
        idx = {}
        for k in self.space:
            col = np.asarray(soa[k], np.float64).reshape(-1)
            idx[k] = np.abs(col[:, None] - self._enc[k][None, :]).argmin(1)
        X = self._features_from_idx(idx)
        with torch.no_grad():
            out = _forward(self.params, self._tensor(X))
        return out.cpu().numpy().astype(np.float64) * self._y_std \
            + self._y_mean

    def predict(self, tunables) -> np.ndarray:
        return self.predict_arrays(tunables_to_arrays(list(tunables)))

    # -- durable-session state (see KermitSession.checkpoint) ----------------

    def export_state(self) -> dict:
        """The reference's JSON layout: hyper-parameters, target scaling and
        the [[W, b], ...] parameters as nested lists."""
        return {
            "space": {k: list(v) for k, v in self.space.items()},
            "hidden": list(self.hidden),
            "epochs": self.epochs,
            "lr": self.lr,
            "seed": self.seed,
            "n_train": self.n_train,
            "y_mean": self._y_mean,
            "y_std": self._y_std,
            "params": None if self.params is None else
                [[W.cpu().numpy().tolist(), b.cpu().numpy().tolist()]
                 for W, b in self.params],
        }

    @classmethod
    def from_state(cls, state: dict, *, device=None) -> "CostModel":
        """A model from ``export_state``'s layout (the reference's too), its
        parameters on ``device`` (None: CUDA)."""
        model = cls(state["space"], hidden=tuple(state["hidden"]),
                    epochs=state["epochs"], lr=state["lr"],
                    seed=state["seed"], device=device)
        if state.get("params") is not None:
            model.params = [(model._tensor(W), model._tensor(b))
                            for W, b in state["params"]]
        model._y_mean = float(state["y_mean"])
        model._y_std = float(state["y_std"])
        model.n_train = int(state.get("n_train", 0))
        return model
