"""The seeded traffic renderer: same seed, same schedule; every seed the
same work per phase block, dealt into windows as a draw (by the mix's
``deal_seed`` where it names one, the same windows on every seed); the
lengths and gaps as the mix file states."""
import numpy as np
import pytest

from kbench import traffic
from kbench.tests.tiny import REPO


@pytest.mark.parametrize("mix", ["code", "short"])
def test_same_seed_same_schedule(mix):
    spec = traffic.load_mix(REPO, mix)
    a = traffic.Traffic(spec, 2 ** 31 + 17, 40).schedule()
    b = traffic.Traffic(spec, 2 ** 31 + 17, 40).schedule()
    for x, y in zip(a, b):
        for f in ("arrivals", "prompt_len", "gen"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    # a file's deal_seed deals every run seed the same windows; without
    # one the run's seed deals
    c = traffic.Traffic(spec, 2 ** 31 + 18, 40).schedule()
    same = all(np.array_equal(getattr(x, f), getattr(y, f))
               for x, y in zip(a, c) for f in ("arrivals", "prompt_len",
                                               "gen"))
    assert same == ("deal_seed" in spec)
    free = {k: v for k, v in spec.items() if k != "deal_seed"}
    a = traffic.Traffic(free, 2 ** 31 + 17, 40).schedule()
    c = traffic.Traffic(free, 2 ** 31 + 18, 40).schedule()
    assert any(not np.array_equal(x.gen, y.gen) for x, y in zip(a, c))


@pytest.mark.parametrize("mix", ["code", "short"])
def test_every_seed_serves_the_same_work(mix):
    spec = {k: v for k, v in traffic.load_mix(REPO, mix).items()
            if k != "deal_seed"}
    runs = [traffic.Traffic(spec, s, 40).schedule() for s in (0, 5, 2 ** 33)]
    for wins in zip(*runs):
        assert len({w.phase for w in wins}) == 1
        assert len({round(float(w.arrivals[-1]), 9) for w in wins}) == 1
    # each phase block holds the same lengths on every seed, in windows
    # that differ from seed to seed
    for block in range(max(w.phase_index for w in runs[0]) + 1):
        for f in ("prompt_len", "gen"):
            held = {tuple(np.sort(np.concatenate(
                [getattr(w, f) for w in run if w.phase_index == block])))
                for run in runs}
            assert len(held) == 1
    assert any(not np.array_equal(np.sort(x.gen), np.sort(y.gen))
               for x, y in zip(runs[0], runs[1]))


def test_code_lengths_follow_the_file():
    spec = traffic.load_mix(REPO, "code")
    t = traffic.Traffic(spec, 3, 16)
    wins = t.schedule()
    assert len(wins) == t.n_windows == 16
    assert t.phase_boundaries() == [4, 8, 12]
    assert [w.phase for w in wins[:8]] == ["sparse"] * 4 + ["dense"] * 4
    # weights 0.15/0.35/0.35/0.15 of a block's 32: 4.8/11.2/11.2/4.8
    # -> 5, 11, 11, 5
    block = np.concatenate([w.prompt_len for w in wins[:4]])
    counts = {b: int((block == b).sum()) for b in (512, 1024, 2048, 4096)}
    assert counts == {512: 5, 1024: 11, 2048: 11, 4096: 5}
    # lognormal quantiles at (k + 0.5)/32 around the median 13, clipped
    gen = np.sort(np.concatenate([w.gen for w in wins[:4]]))
    assert gen.min() >= 1 and gen.max() <= 64
    assert gen[15] <= 13 <= gen[16]
    assert all(len(w.gen) == len(w.prompt_len) == 8 for w in wins)
    # the first request at the window's start, then 7 exponential gaps
    # with the phase's mean: its quantiles, their mean near it
    assert wins[0].arrivals[0] == 0.0
    gaps = np.diff(wins[0].arrivals)
    np.testing.assert_allclose(np.sort(gaps), traffic.gap_quantiles(4.0, 7))
    assert abs(gaps.mean() - 4.0) < 0.6
    gaps = np.diff(wins[4].arrivals)
    assert abs(gaps.mean() - 1.25) < 0.2


def test_short_lengths_follow_the_file():
    wins = traffic.Traffic(traffic.load_mix(REPO, "short"), 9, 8).schedule()
    gen = np.concatenate([w.gen for w in wins[:8]])
    # uniform on [1, 16]: each length 4 times in a block of 64
    assert sorted(gen.tolist()) == sorted(list(range(1, 17)) * 4)
    prompts = np.concatenate([w.prompt_len for w in wins[:8]])
    assert sorted(set(prompts.tolist())) == [64, 128, 256]
    assert sorted(traffic.bucket_counts([1, 1, 1], 64)) == [21, 21, 22]


def test_bucket_counts_and_quantiles():
    assert traffic.bucket_counts([1, 1, 1], 8) == [3, 3, 2]
    assert sum(traffic.bucket_counts([0.15, 0.35, 0.35, 0.15], 33)) == 33
    q = traffic.output_quantiles({"dist": "uniform", "min": 1, "max": 4}, 4)
    assert q.tolist() == [1, 2, 3, 4]
    np.testing.assert_allclose(traffic.gap_quantiles(2.0, 2),
                               [-2 * np.log(0.75), -2 * np.log(0.25)])
