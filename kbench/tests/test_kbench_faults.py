"""A whole run on the CPU (the harness's look for a chip skipped) with
the timed path broken underneath: ``correct`` has to come out false, once
for each fault a serving cell can have, and true with none."""
import time

import pytest
import torch

from kbench import harness
from kbench.tests import tiny


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One torch thread while a window runs (six test workers share the
    cores), restored after; and the run's import rule left to
    ``test_kbench_imports.py``, since a test worker also runs the files
    that load the JAX package."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def state_unchanged(monkeypatch, M):
    """Each decode step computes from its cache but leaves it as it was."""
    real = M.decode

    def decode(params, cfg, batch, cache, tun):
        logits, _ = real(params, cfg, batch, _clone(cache), tun)
        return logits, cache
    monkeypatch.setattr(M, "decode", decode)


def half_batch(monkeypatch, M):
    """The second half of a prefill's rows is left out: it is computed from
    the first half's prompts."""
    real = M.prefill

    def prefill(params, cfg, batch, tun, cache=None):
        tok = batch["tokens"].clone()
        h = tok.shape[0] // 2
        tok[h:2 * h] = tok[:h]
        return real(params, cfg, {**batch, "tokens": tok}, tun, cache=cache)
    monkeypatch.setattr(M, "prefill", prefill)


def token_altered(monkeypatch, M):
    """The first row's token of every decode step is the runner-up."""
    real = M.decode

    def decode(params, cfg, batch, cache, tun):
        logits, cache = real(params, cfg, batch, cache, tun)
        logits = logits.clone()
        second = logits[0, -1].topk(2).indices[1]
        logits[0, -1, second] = logits[0, -1].max() + 1.0
        return logits, cache
    monkeypatch.setattr(M, "decode", decode)


def labels_altered(monkeypatch, M):
    """Every DBSCAN discovery returns its first point relabelled."""
    import importlib
    D = importlib.import_module("repro_torch.core.dbscan")
    real = D.labels_from_adjacency

    def labels(*a, **kw):
        out = real(*a, **kw).copy()
        out[0] = out.max() + 1
        return out
    monkeypatch.setattr(D, "labels_from_adjacency", labels)


def _run(root, family, seed=2 ** 32 + 3, seconds=1.5):
    return harness.measure(root, f"tiny-{family}.mix", seed, seconds, False,
                           time.perf_counter(), device="cpu",
                           log=lambda *a, **k: None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("faults"),
                          ("qwen2", "mamba2"), limit=0.01)


@pytest.mark.parametrize("family", ["qwen2", "mamba2"])
def test_sound_run_is_correct(root, family):
    res = _run(root, family)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered, labels_altered])
@pytest.mark.parametrize("family", ["qwen2", "mamba2"])
def test_fault_is_caught(root, monkeypatch, family, fault):
    from repro_torch.models import model as M
    fault(monkeypatch, M)
    # the window has to reach an analysis for the labels' fault
    res = _run(root, family, seconds=4.0 if fault is labels_altered else 1.5)
    assert not res["correct"], res["checks"]
    # caught by the number that the fault moves, with the window holding
    # a discovery all the same
    c = res["checks"]
    assert c["dbscan_discoveries"]["value"] >= 1, c
    if fault is labels_altered:
        assert c["dbscan_mismatches"]["value"] > 0, c
    else:
        assert c["logit_gap"]["value"] > c["logit_gap"]["limit"], c
