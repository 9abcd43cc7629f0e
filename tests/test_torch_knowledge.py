"""The port's WorkloadDB against the JAX reference: batched match labels,
drift/merge/evict journals, and the shared workloads.json format."""
import numpy as np
import pytest

from repro.core.characterize import characterize
from repro.core.knowledge import WorkloadDB as JDB
from repro_torch.convert import workload_db_from_reference
from repro_torch.core.knowledge import WorkloadDB as PDB


def _chars(seed, n_classes=6, per=5):
    """Characterizations of windows drawn around a few class centres (with
    repeats and near misses), in the order an analysis would see them."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 1, (n_classes, 16)).astype(np.float32)
    out = []
    for k in range(n_classes * per):
        c = centres[rng.integers(n_classes)]
        scale = rng.choice([0.01, 0.05, 0.3])
        w = c + rng.normal(0, scale, (int(rng.integers(4, 40)), 16))
        out.append(characterize(w.astype(np.float32)))
    return out


def _drive(db, chars):
    """Algorithm 2's discovery step, record by record: match, then observe
    or insert; returns the label decisions and the drift flags."""
    labels = []
    for c in chars:
        m = db.find_match(c)
        if m is None:
            labels.append(("new", db.insert(c)))
        else:
            labels.append(("match", m, db.observe(m, c)))
    return labels


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [{}, {"drift_eps": 0.05, "drift_alpha": 0.3},
                                {"merge_eps": 0.2, "max_records": 4}])
def test_match_labels_and_journal_match_reference(seed, kw):
    chars = _chars(seed)
    ref, port = JDB(None, **kw), PDB(None, device="cpu", **kw)
    assert _drive(port, chars) == _drive(ref, chars)
    assert port.consolidate() == ref.consolidate()
    assert port.drain_events() == ref.drain_events()
    assert port.labels() == ref.labels()
    assert port.aliases == ref.aliases
    for label in ref.labels():
        a, b = port.records[label], ref.records[label]
        for key in ("mean", "std", "p75", "p90"):
            np.testing.assert_array_equal(a.characterization[key],
                                          b.characterization[key])
        assert a.characterization["n"] == b.characterization["n"]
        assert (a.is_drifting, a.drift_score) == (b.is_drifting,
                                                  b.drift_score)


def test_nearest_config_matches_reference():
    chars = _chars(3)
    ref, port = JDB(None), PDB(None, device="cpu")
    _drive(ref, chars)
    _drive(port, chars)
    for i, label in enumerate(ref.labels()[::2]):
        cfg = {"microbatches": i + 1}
        ref.set_config(label, cfg, optimal=True)
        port.set_config(label, cfg, optimal=True)
    for c in chars:
        assert port.nearest_config(c) == ref.nearest_config(c)


def _same_store(a, b):
    assert a._next_label == b._next_label
    assert a.aliases == b.aliases
    assert sorted(a.records) == sorted(b.records)
    for label, ra in a.records.items():
        rb = b.records[label]
        assert (ra.config, ra.has_optimal, ra.is_synthetic, ra.pair) == \
            (rb.config, rb.has_optimal, rb.is_synthetic, rb.pair)
        np.testing.assert_array_equal(ra.characterization["mean"],
                                      rb.characterization["mean"])
        np.testing.assert_array_equal(ra.origin_mean, rb.origin_mean)


def test_workloads_json_moves_both_ways(tmp_path):
    chars = _chars(4)
    ref = JDB(None, merge_eps=0.2)
    _drive(ref, chars)
    ref.consolidate()
    ref.insert({"mean": np.zeros(16), "std": np.ones(16), "n": 100},
               is_synthetic=True, pair=(0, 1))
    ref.set_config(ref.labels()[0], {"remat": "none"}, optimal=True)
    ref.save(tmp_path / "ref.json")

    port = workload_db_from_reference(tmp_path / "ref.json", device="cpu")
    _same_store(port, ref)
    assert port.find_synthetic((0, 1)) == ref.find_synthetic((0, 1))

    port.insert(chars[0])
    port.save(tmp_path / "port.json")
    back = JDB(None)
    assert back.load(tmp_path / "port.json")
    _same_store(back, port)
    assert JDB(tmp_path / "zones").labels() == []          # fresh root
    assert PDB(tmp_path / "zones2", device="cpu").labels() == []
    legacy = PDB(None, impl="legacy", device="cpu")
    assert legacy.load(tmp_path / "ref.json")
    _same_store(legacy, ref)
    for c in chars[:6]:
        assert legacy.find_match(c) == ref.find_match(c, impl="legacy") \
            == legacy.find_match(c, impl="auto")
