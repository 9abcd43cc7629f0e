"""WorkloadPredictor: LSTM over the label stream predicting the workload
label at horizons t+1, t+5, t+10 (the paper's workload-context fields).

Port of ``repro/core/lstm.py``.  Plain tensor ops: a Python loop over time
steps takes the place of ``lax.scan``, gradients come from autograd, and
the update is the reference's AdamW (``optim/adamw.py``).  Parameters are
a dict of tensors with the reference's names and shapes.

Random draws — the initial parameters and one permutation per epoch — come
from ``_init_draws`` and ``_permutations``, both on a CPU generator so the
CPU and the card draw the same numbers; tests replace them with the
reference's ``jax.random`` draws.  The numpy subsample of long histories
(``max_train_samples``) makes the reference's own numpy call.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map)

HORIZONS = (1, 5, 10)


@dataclass(frozen=True)
class PredictorConfig:
    n_classes: int = 8
    hidden: int = 64
    window: int = 16            # history length fed to the LSTM
    epochs: int = 60            # maximum epochs (cap when early-stopping)
    batch: int = 64
    lr: float = 5e-3
    early_stop_tol: float = 0.0   # stop when the relative per-epoch loss
    patience: int = 2             # improvement stays < tol for `patience`
                                  # epochs; 0.0 = always run all epochs
    max_train_samples: int = 0    # uniform subsample of history windows
                                  # (keeps label coverage); 0 = use all
    target_loss: float = 0.0      # absolute early exit: stop once the mean
                                  # epoch loss reaches this; 0.0 = disabled


def _init_draws(seed: int, pc: PredictorConfig) -> dict:
    """Initial parameters (CPU tensors): N(0, 0.1²) weights, zero biases."""
    g = torch.Generator().manual_seed(int(seed))
    C, H = pc.n_classes, pc.hidden
    s = 0.1

    def normal(*shape):
        return torch.randn(shape, generator=g) * s

    return {
        "wx": normal(C, 4 * H),
        "wh": normal(H, 4 * H),
        "b": torch.zeros(4 * H),
        "heads": {f"h{h}": normal(H, C) for h in HORIZONS},
        "head_b": {f"h{h}": torch.zeros(C) for h in HORIZONS},
    }


def _permutations(seed: int, n: int):
    """One permutation of range(n) per epoch (CPU int64 tensors)."""
    g = torch.Generator().manual_seed(int(seed))
    while True:
        yield torch.randperm(n, generator=g)


def one_hot(labels, n_classes: int):
    """float32 one-hot; out-of-range labels (UNKNOWN = -1, or a class the
    model was not trained on) give an all-zero row, as ``jax.nn.one_hot``
    does."""
    return (labels[..., None] == torch.arange(
        n_classes, device=labels.device)).to(torch.float32)


def _forward(params, xs):
    """xs: (B, W, C) one-hot history -> dict horizon -> (B, C) logits."""
    B = xs.shape[0]
    H = params["wh"].shape[0]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    for t in range(xs.shape[1]):
        z = xs[:, t] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = torch.split(z, H, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return {hz: h @ params["heads"][f"h{hz}"] + params["head_b"][f"h{hz}"]
            for hz in HORIZONS}


# the forward pass doubles as the monitor's fused-step entry point
forward_logits = _forward


def _make_dataset(labels: np.ndarray, pc: PredictorConfig):
    W = pc.window
    hmax = max(HORIZONS)
    n = len(labels) - W - hmax
    if n <= 0:
        raise ValueError("label sequence too short for predictor training")
    xs = np.lib.stride_tricks.sliding_window_view(labels, W)[:n]
    ys = {h: labels[W + h - 1:W + h - 1 + n] for h in HORIZONS}
    return np.ascontiguousarray(xs), ys


def _loss_fn(p, xb, yb):
    logits = _forward(p, xb)
    total = 0.0
    for h in HORIZONS:
        lp = torch.log_softmax(logits[h], dim=-1)
        total = total - torch.mean(torch.gather(lp, 1, yb[h][:, None]))
    return total / len(HORIZONS)


def _train_step(params, opt, xb, yb, oc: OptConfig):
    """One minibatch: loss, autograd gradients, AdamW update."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    loss = _loss_fn(p, xb, yb)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    g = tree_map(lambda _: next(it), params)
    new_p, new_opt, _ = adamw_update(g, opt, params, oc)
    return new_p, new_opt, loss.detach()


def _train(params, opt, xs_oh, ys, perms, pc: PredictorConfig,
           oc: OptConfig, n_batches: int, min_epochs: int = 0):
    """The training run: an epoch loop over ``n_batches`` minibatches of a
    fresh permutation (the reference's ``order[i:i + batch]`` windows).

    With ``pc.early_stop_tol > 0`` training stops once the mean epoch loss
    stops improving by the relative tolerance for ``pc.patience``
    consecutive epochs after ``min_epochs`` (or reaches ``pc.target_loss``
    once past ``min_epochs``).  Returns (params, opt, losses or best)."""
    def run_epoch(p, o):
        order = next(perms).to(xs_oh.device)
        sls = order[:n_batches * pc.batch].reshape(n_batches, pc.batch)
        losses = []
        for sl in sls:
            p, o, loss = _train_step(p, o, xs_oh[sl],
                                     {h: ys[h][sl] for h in HORIZONS}, oc)
            losses.append(loss)
        return p, o, torch.stack(losses).mean()

    if pc.early_stop_tol <= 0.0:
        losses = []
        for _ in range(pc.epochs):
            params, opt, ml = run_epoch(params, opt)
            losses.append(ml)
        return params, opt, torch.stack(losses)

    e, bad = 0, 0
    best = torch.tensor(float("inf"))
    while e < pc.epochs and bad < pc.patience and not (
            pc.target_loss > 0.0 and e >= min_epochs
            and bool(best <= pc.target_loss)):
        params, opt, ml = run_epoch(params, opt)
        ml = ml.cpu()
        improved = bool(ml < best * (1.0 - pc.early_stop_tol))
        # plateau accounting starts after lr warmup (min_epochs)
        bad = 0 if (improved or e < min_epochs) else bad + 1
        best = torch.minimum(best, ml)
        e += 1
    return params, opt, best


class WorkloadPredictor:
    def __init__(self, pc: PredictorConfig, *, device=None):
        self.pc = pc
        self.device = resolve_device(device)
        self.params = None

    def fit(self, labels: np.ndarray, seed: int = 0):
        pc = self.pc
        dev = self.device
        xs, ys = _make_dataset(np.asarray(labels, np.int32), pc)
        if pc.max_train_samples and len(xs) > pc.max_train_samples:
            # bound training compute on long histories without losing label
            # coverage: uniform subsample over the whole window history
            pick = np.random.default_rng(seed + 17).choice(
                len(xs), pc.max_train_samples, replace=False)
            xs = xs[pick]
            ys = {h: v[pick] for h, v in ys.items()}
        xs_oh = one_hot(torch.as_tensor(xs, dtype=torch.long, device=dev),
                        pc.n_classes)
        ys = {h: torch.as_tensor(v, dtype=torch.long, device=dev)
              for h, v in ys.items()}
        params = tree_map(lambda t: t.to(device=dev, dtype=torch.float32),
                          _init_draws(seed, pc))
        oc = OptConfig(lr=pc.lr, warmup=10, total_steps=pc.epochs * 8,
                       weight_decay=0.0, grad_clip=1.0)
        opt = adamw_init(params, oc)
        n = xs_oh.shape[0]
        n_batches = max((n - pc.batch) // pc.batch + 1, 0) \
            if n >= pc.batch else 0
        if n_batches:
            min_epochs = -(-oc.warmup // n_batches) + pc.patience + 2
            params, opt, _ = _train(params, opt, xs_oh, ys,
                                    _permutations(seed + 1, n), pc, oc,
                                    n_batches, min_epochs=min_epochs)
        self.params = params
        return self

    def predict(self, history: np.ndarray) -> dict:
        """history: (W,) or (B, W) label ids -> {horizon: (B,) predicted}."""
        h = np.asarray(history, np.int64)
        if h.ndim == 1:
            h = h[None]
        xs = one_hot(torch.as_tensor(h[:, -self.pc.window:],
                                     device=self.device), self.pc.n_classes)
        with torch.no_grad():
            logits = _forward(self.params, xs)
        return {hz: torch.argmax(l, -1).cpu().numpy()
                for hz, l in logits.items()}

    def score(self, labels: np.ndarray) -> dict:
        xs, ys = _make_dataset(np.asarray(labels, np.int32), self.pc)
        preds = self.predict(xs)
        return {h: float(np.mean(preds[h] == ys[h])) for h in HORIZONS}
