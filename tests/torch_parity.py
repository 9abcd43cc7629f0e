"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

The port draws its random numbers from torch generators; the reference
draws from ``jax.random``.  To compare the two decision for decision, these
helpers compute the reference's own draws (same key chains as
``repro/core/forest.py`` and ``repro/core/lstm.py``) and hand them to the
port through its draw functions.  Data moves between the frameworks as
numpy arrays.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

# the parity tests run on tiny tensors beside other test workers: one
# intra-op thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def to_torch(a, dtype="float32"):
    """A float32 numpy array as a CPU tensor of ``dtype`` (bf16 rounds to
    nearest even, as ``astype`` does in JAX)."""
    return torch.tensor(a).to(getattr(torch, dtype))


def to_jax(a, dtype="float32"):
    return jax.numpy.asarray(a).astype(dtype)


def blobs(n, f, seed, spread=0.5, shift=3.0):
    """The reference tests' three-blob point cloud."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32) * spread
    x[: n // 2] += shift
    x[n // 4: n // 2] -= 2 * shift
    return x


def jax_forest_draws(seed, n_trees, n, s, f, feature_frac):
    """``repro.core.forest``'s bootstrap rows and feature masks for a fit
    with ``seed`` (its key chain: split per tree, then bootstrap/tree keys,
    then feature-mask keys)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_trees)
    rows, masks = [], []
    for key in keys:
        bkey, tkey = jax.random.split(key)
        rows.append(np.asarray(jax.random.randint(bkey, (s,), 0, n)))
        fkey, ikey = jax.random.split(tkey)
        m = np.asarray(jax.random.uniform(fkey, (f,)) < feature_frac).copy()
        m[int(jax.random.randint(ikey, (), 0, f))] = True
        masks.append(m)
    return (torch.as_tensor(np.stack(rows)).long(),
            torch.as_tensor(np.stack(masks)))


def _to_torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def jax_lstm_init(seed, pc):
    """``repro.core.lstm._init(PRNGKey(seed), pc)`` as CPU tensors."""
    from repro.core import lstm as J
    ref_pc = J.PredictorConfig(**dataclasses.asdict(pc))
    return _to_torch_tree(J._init(jax.random.PRNGKey(seed), ref_pc))


def jax_permutations(seed, n):
    """The reference's per-epoch permutations: key = PRNGKey(seed), then
    ``key, sk = split(key); permutation(sk, n)`` each epoch."""
    key = jax.random.PRNGKey(seed)
    while True:
        key, sk = jax.random.split(key)
        yield torch.as_tensor(np.asarray(jax.random.permutation(sk, n))).long()


@pytest.fixture
def reference_draws(monkeypatch):
    """Route every random draw of the port's forest and LSTM fits through
    the reference's ``jax.random`` draws."""
    import repro_torch.core.forest as F
    import repro_torch.core.lstm as L
    monkeypatch.setattr(F, "_forest_draws", jax_forest_draws)
    monkeypatch.setattr(L, "_init_draws", jax_lstm_init)
    monkeypatch.setattr(L, "_permutations", jax_permutations)
