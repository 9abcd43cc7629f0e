"""The port's ``BatchedWindowRing`` against the reference's and against S
port ``WindowRing``s: the same seeded ticks, across the wrap, give the same
slots, reads and exported state, array for array."""
import numpy as np
import pytest

from repro.core.windows import BatchedWindowRing as JRing
from repro_torch.core.windows import BatchedWindowRing, WindowRing

W = 16


def _ticks(S, F, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.normal(size=(S, F)).astype(np.float32),
               rng.uniform(0.1, 1.0, size=(S, F)).astype(np.float32),
               rng.integers(-1, 6, size=S).astype(np.int32))


@pytest.mark.parametrize("S,cap,F,n", [(3, 4, 2, 7), (5, 8, 16, 8),
                                       (2, 2, 3, 5), (4, 16, 16, 37)])
def test_ring_equals_reference_and_scalar_rings(S, cap, F, n):
    ring = BatchedWindowRing(S, cap, F, W)
    ref = JRing(S, cap, F, W)
    scalars = [WindowRing(cap, F, W) for _ in range(S)]
    k = min(cap, 5)
    for step, (mean, var, label) in enumerate(_ticks(S, F, n, seed=n)):
        ring.push_tick(mean, var, label)
        ref.push_tick(mean, var, label)
        for s in range(S):
            scalars[s].push(mean[s], var[s], int(label[s]))
        assert ring.total == ref.total == step + 1
        assert len(ring) == len(ref) == len(scalars[0])
        np.testing.assert_array_equal(ring.last_labels(k), ref.last_labels(k))
        pm, pv = ring.last_window()
        rm, rv = ref.last_window()
        np.testing.assert_array_equal(pm, rm)
        np.testing.assert_array_equal(pv, rv)
        for s in range(S):
            got = ring.ordered(s)
            for a, b, c in zip(got, ref.ordered(s), scalars[s].ordered()):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
                assert a.dtype == b.dtype
            np.testing.assert_array_equal(ring.last_labels(k)[s],
                                          scalars[s].last_labels(k))
            ws = ring.series(s, copy=True)
            assert ws.count == W
            np.testing.assert_array_equal(ws.var, scalars[s].series().var)
    meta, arrays = ring.export_state()
    rmeta, rarrays = ref.export_state()
    assert meta == rmeta
    assert arrays.keys() == rarrays.keys()
    for key in arrays:
        np.testing.assert_array_equal(arrays[key], rarrays[key])
        assert arrays[key].dtype == rarrays[key].dtype


def test_state_round_trips_across_packages():
    ring = BatchedWindowRing(2, 3, 2, W)
    for mean, var, label in _ticks(2, 2, 5, seed=3):
        ring.push_tick(mean, var, label)
    back = BatchedWindowRing.from_state(*ring.export_state())
    into_ref = JRing.from_state(*ring.export_state())
    from_ref = BatchedWindowRing.from_state(*into_ref.export_state())
    for other in (back, into_ref, from_ref):
        assert other.total == ring.total
        for s in range(2):
            for a, b in zip(other.ordered(s), ring.ordered(s)):
                np.testing.assert_array_equal(a, b)


def test_views_until_the_wrap_then_copies():
    ring = BatchedWindowRing(2, 4, 2, W)
    ticks = list(_ticks(2, 2, 5, seed=4))
    for mean, var, label in ticks[:3]:
        ring.push_tick(mean, var, label)
    m, _, _ = ring.ordered(0)
    assert np.shares_memory(m, ring.mean)
    assert not np.shares_memory(ring.ordered(0, copy=True)[0], ring.mean)
    for mean, var, label in ticks[3:]:
        ring.push_tick(mean, var, label)
    m, _, l = ring.ordered(1)
    assert not np.shares_memory(m, ring.mean)
    np.testing.assert_array_equal(l, [t[2][1] for t in ticks[1:]])


@pytest.mark.parametrize("args,match", [((0, 4, 2, W), "at least one"),
                                        ((2, 1, 2, W), "capacity")])
def test_ring_validation(args, match):
    with pytest.raises(ValueError, match=match):
        BatchedWindowRing(*args)
    with pytest.raises(ValueError, match=match):
        JRing(*args)


def test_empty_ring_and_history_bounds():
    ring = BatchedWindowRing(2, 4, 2, W)
    with pytest.raises(ValueError, match="empty"):
        ring.last_window()
    assert ring.last_labels(0).shape == (2, 0)
    np.testing.assert_array_equal(ring.last_labels(3), np.full((2, 3), -1))
    with pytest.raises(ValueError, match="exceeds retention"):
        ring.last_labels(5)
