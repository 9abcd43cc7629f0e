"""The port's ``kmeans`` (the Fig-10 baseline clusterer) against the
reference's: with the reference's centroid draw injected, the labels are
equal on ``benchmarks/bench_clustering.py``'s six seeded window series, at
the true class count and two above it."""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core.dbscan import kmeans as ref_kmeans
from repro.core.simulator import generate, random_schedule
from repro_torch.core import kmeans

PD = importlib.import_module("repro_torch.core.dbscan")


def _jax_draws(seed, n, k):
    """``jax.random.choice(PRNGKey(seed), n, (k,), replace=False)``."""
    idx = jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False)
    return torch.as_tensor(np.array(idx)).long()


def _fig10_series(seed):
    sched = random_schedule(6, seed=seed + 10,
                            subset=["dense_train", "decode_serve",
                                    "long_prefill", "moe_train"])
    sim = generate(sched, window_size=24, seed=seed, transition_windows=0)
    gt = sim.window_labels
    return sim.windows.mean, len(np.unique(gt[gt >= 0]))


@pytest.mark.parametrize("seed", range(6))
def test_labels_equal_reference(monkeypatch, seed):
    monkeypatch.setattr(PD, "_kmeans_draws", _jax_draws)
    x, k_true = _fig10_series(seed)
    for k in (k_true, k_true + 2):
        got = kmeans(x, k, device="cpu")
        np.testing.assert_array_equal(got, np.asarray(ref_kmeans(x, k)))
        assert got.shape == (len(x),) and got.max() < k


def test_own_draws_are_distinct_points_and_seeded():
    idx = PD._kmeans_draws(3, 50, 7)
    assert len(set(idx.tolist())) == 7 and idx.max() < 50
    assert torch.equal(idx, PD._kmeans_draws(3, 50, 7))
    x, k = _fig10_series(0)
    a = kmeans(torch.from_numpy(x), k)            # a tensor keeps its device
    np.testing.assert_array_equal(a, kmeans(x, k, device="cpu"))


def test_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans(np.zeros((4, 2), np.float32), 2)
