"""The benchmark's latency arithmetic against the program's
``ServeExecutor._replay`` on a CPU engine, under one clock that moves
only inside the model's prefill and decode, so both sides read the same
times and must agree exactly."""
import time

import numpy as np
import pytest

from kbench import harness, replay
from kbench.tests import tiny


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("family", ["qwen2", "mamba2"])
def test_latencies_equal_the_programs(tmp_path, monkeypatch, family):
    from repro_torch.models import model as M
    root = tiny.make_root(tmp_path, (family,))
    bench = harness.Bench(root, f"tiny-{family}.mix", "cpu")
    bench.prepare(2 ** 31 + 5)
    ex, session = bench.session(2 ** 31 + 5)
    bench._wrap_session(ex, session)
    bench.rec.reset()
    clock = Clock()
    real_prefill, real_decode = M.prefill, M.decode

    def prefill(params, cfg, batch, tun, cache=None):
        B, S = batch["tokens"].shape
        clock.t += 1e-4 * B * S
        return real_prefill(params, cfg, batch, tun, cache=cache)

    def decode(params, cfg, batch, cache, tun):
        clock.t += 1e-3 * batch["tokens"].shape[0] + 2e-3
        return real_decode(params, cfg, batch, cache, tun)
    monkeypatch.setattr(M, "prefill", prefill)
    monkeypatch.setattr(M, "decode", decode)
    monkeypatch.setattr(time, "perf_counter", clock)
    wins = ex.windows
    for w in wins[:3]:
        ex.serve_window(w)
    ex.apply(bench.initial.replace(serve_batch=2))
    for w in wins[3:6]:
        ex.serve_window(w)
    ex.apply(bench.initial.replace(serve_batch=4))
    for w in wins[6:8]:
        ex.serve_window(w)
    unit, source = replay.unit_from_spans(bench.rec, bench.initial)
    assert source == "spans" and unit == ex._unit
    lat = replay.latencies(bench.rec, ex._unit)
    assert len(lat) == len(ex.request_latencies) == 8 * 8
    np.testing.assert_allclose(lat, ex.request_latencies, rtol=0,
                               atol=1e-9)
    # every chunk found its call: 1 + 4 + 2 chunks a window
    assert [len(w["chunks"]) for w in bench.rec.windows] == \
        [1] * 3 + [4] * 3 + [2] * 2


def test_served_tokens_counts_every_committed_request():
    calls = [{"real_rows": 2, "gen": np.array([4, 1, 1])},
             {"real_rows": 3, "gen": np.array([0, 2, 7])}]
    # gen + 1 a request; the first call's pad row left out
    assert replay.served_tokens(calls) == (5 + 2) + (1 + 3 + 8)
    assert replay.served_tokens([]) == 0


def test_p95_nearest_rank():
    assert replay.p95_nearest_rank(range(1, 101)) == 95
    assert replay.p95_nearest_rank([3.0]) == 3.0
    assert replay.p95_nearest_rank(range(1, 21)) == 19
