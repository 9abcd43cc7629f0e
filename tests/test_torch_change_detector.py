"""The port's Welch change detector against the JAX reference: transition
flags bit-identical in batch and stream mode on simulator telemetry."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import change_detector as J
from repro.core.simulator import generate, random_schedule
from repro.core.windows import make_windows as j_make_windows
from repro_torch.core import change_detector as P
from repro_torch.core.windows import make_windows


def _stream(window_size, seed, n_segments=12):
    sched = random_schedule(n_segments, min_len=4, max_len=12, seed=seed)
    return generate(sched, window_size=window_size, seed=seed).samples


@pytest.mark.parametrize("window_size,seed", [(16, 0), (32, 1), (7, 2)])
def test_make_windows_matches_reference(window_size, seed):
    s = _stream(window_size, seed)
    a, b = make_windows(s, window_size), j_make_windows(s, window_size)
    np.testing.assert_array_equal(a.mean, b.mean)
    np.testing.assert_array_equal(a.var, b.var)
    assert a.count == b.count


@pytest.mark.parametrize("window_size,seed", [(16, 0), (32, 1), (7, 2)])
@pytest.mark.parametrize("alpha,quorum", [(0.01, 0.25), (0.001, 0.5)])
def test_batch_flags_match_reference(window_size, seed, alpha, quorum):
    ws = make_windows(_stream(window_size, seed), window_size)
    want = J.ChangeDetector(alpha=alpha, quorum=quorum).batch(ws)
    got = P.ChangeDetector(alpha=alpha, quorum=quorum, device="cpu").batch(ws)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)


def test_batch_flags_with_feature_mask_match_reference():
    ws = make_windows(_stream(16, 4), 16)
    mask = np.arange(16) % 3 != 0
    want = J.ChangeDetector(feature_mask=mask).batch(ws)
    got = P.ChangeDetector(feature_mask=mask, device="cpu").batch(ws)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window_size", [16, 32])
def test_stream_flags_match_reference(window_size):
    ws = make_windows(_stream(window_size, 5), window_size)
    ref = J.ChangeDetector()
    port = P.ChangeDetector(device="cpu")
    prev = None
    for lo in range(0, len(ws), 19):               # uneven chunks
        m, v = ws.mean[lo:lo + 19], ws.var[lo:lo + 19]
        want = ref.stream(prev, m, v, window_size)
        got = port.stream(prev, m, v, window_size)
        np.testing.assert_array_equal(got, want)
        prev = (m[-1], v[-1], window_size)


def test_critical_value_matches_reference_bitwise():
    dof = np.geomspace(0.5, 500.0, 997).astype(np.float32)
    for alpha in (0.05, 0.01, 0.001):
        want = np.asarray(jax.jit(lambda d: J._t_crit(d, alpha))(
            jnp.asarray(dof)))
        got = P._t_crit(torch.from_numpy(dof), alpha).numpy()
        np.testing.assert_array_equal(got, want)


def test_online_pair_and_characterization_match_reference():
    ws = make_windows(_stream(16, 6), 16)
    ref, port = J.ChangeDetector(), P.ChangeDetector(device="cpu")
    for t in range(1, 40):
        a = (ws.mean[t - 1], ws.var[t - 1], 16)
        b = (ws.mean[t], ws.var[t], 16)
        assert port.online(a, b) == ref.online(a, b)
    c1 = {"mean": ws.mean[:20].mean(0), "std": ws.mean[:20].std(0), "n": 20}
    c2 = {"mean": ws.mean[20:50].mean(0), "std": ws.mean[20:50].std(0),
          "n": 30}
    assert port.match_characterization(c1, c2) == \
        ref.match_characterization(c1, c2)
