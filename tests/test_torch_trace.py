"""The span recorder (``repro_torch/runtime/trace.py``) inside the serving
loop, on the CPU: the span tree of a tiny ``ServeExecutor`` session, the
ring's bound, the switch, the program's timers read from the spans, the
executor's warm-up and calibration purposes, and the decode step's
detail spans under a profiler only."""
import collections
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import Tunables
from repro_torch.kermit import (AnalysisConfig, KermitConfig, KermitSession,
                                KnowledgeConfig, MonitorConfig, PlanConfig,
                                ServeConfig, ServeEngine, ServeExecutor,
                                TrafficGenerator, run_serving_session)
from repro_torch.kermit.serving import tiny_config
from repro_torch.models import model as M
from repro_torch.runtime import trace as T

INITIAL = Tunables(serve_batch=8, cache_len=64)
SPACE = {"serve_batch": [2, 4, 8], "cache_len": [64]}
# (parent, child) names the serving loop may record
TREE = {
    ("", "session.run_live"),
    ("session.run_live", "executor.window"),
    ("session.run_live", "analyse.discover"),
    ("session.run_live", "analyse.train"),
    ("session.run_live", "executor.trial"),     # the plan search's trials
    ("analyse.discover", "analyse.dbscan"),
    ("analyse.train", "analyse.forest"),
    ("analyse.train", "analyse.predictor"),
    ("executor.trial", "executor.chunk"),
    ("executor.window", "executor.chunk"),
    ("executor.window", "engine.serve"),          # the calibration
    ("executor.chunk", "engine.serve"),
    ("engine.serve", "engine.prefill"),
    ("engine.serve", "engine.decode"),
}
DETAIL = {"engine.step", "engine.sample", "model.embed", "model.views",
          "model.layer", "model.head"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(arch="qwen2-1.5b", windows=(12, 12)):
    initial = INITIAL if arch == "qwen2-1.5b" else INITIAL.replace(
        attn_impl="pallas", ssm_chunk=16)
    engine = ServeEngine(tiny_config(arch), initial=initial, device="cpu")
    traffic = TrafficGenerator.diurnal(window_size=8, seed=0,
                                       night_windows=windows[0],
                                       day_windows=windows[1])
    ex = ServeExecutor(engine, traffic, config=ServeConfig(window_size=8),
                       initial=initial)
    cfg = KermitConfig(monitor=MonitorConfig(window_size=8),
                       analysis=AnalysisConfig(interval=4, min_windows=4),
                       knowledge=KnowledgeConfig(drift_eps=0.45),
                       plan=PlanConfig(space=SPACE,
                                       default_tunables=initial.as_dict()))
    return engine, ex, cfg


def _run(windows=(12, 12)):
    engine, ex, cfg = _stack(windows=windows)
    with KermitSession(cfg, executor=ex, device="cpu") as session:
        final = run_serving_session(session, ex)
    return ex, session, final


@pytest.fixture(scope="module")
def loop():
    """One tiny session, night then day, with its spans."""
    T.reset()
    ex, session, final = _run()
    return ex, session, T.snapshot(), T.dropped


def _by_id(spans):
    return {s.id: s for s in spans}


def _children(spans, parent, name=None):
    return sorted((s for s in spans if s.parent == parent.id
                   and (name is None or s.name == name)),
                  key=lambda s: s.id)


def test_span_tree_and_request_ids(loop):
    ex, session, spans, dropped = loop
    assert dropped == 0
    by_id = _by_id(spans)
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == ["session.run_live"]
    assert roots[0].attrs == {"dropped": 0}    # the ring's losses at open
    pairs = {(by_id[s.parent].name if s.parent else "", s.name)
             for s in spans}
    assert pairs <= TREE, pairs - TREE
    names = collections.Counter(s.name for s in spans)
    # the loop reached every layer: analyses, a plan search with trials
    assert names["analyse.discover"] >= 1 and names["executor.trial"] >= 1
    assert names["executor.window"] == ex.windows_served == len(ex.windows)
    for s in spans:                        # a child lies inside its parent
        if s.parent:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end
    # each committed window's chunks carry its requests, in order, once
    windows = _children(spans, roots[0], "executor.window")
    for w, log in zip(windows, ex.window_log):
        assert w.attrs == {"window": log["window"]}
        chunks = _children(spans, w, "executor.chunk")
        ids = [i for c in chunks for i in c.attrs["requests"]]
        assert ids == list(range(8))
        assert all(c.attrs["window"] == w.attrs["window"] for c in chunks)
        assert all(c.attrs["real_rows"] == len(c.attrs["requests"])
                   for c in chunks)
        for c in chunks:
            served = [s for s in _children(spans, c, "engine.serve")
                      if s.attrs["purpose"] == "serve"]
            assert len(served) == 1
            assert served[0].attrs["batch"] == log["tunables"]["serve_batch"]
    assert [w.attrs["window"] for w in windows] == \
        [int(w.index) for w in ex.windows]


def test_no_detail_spans_without_a_profiler(loop):
    _, _, spans, _ = loop
    assert not DETAIL & {s.name for s in spans}


def test_program_timers_are_span_durations(loop):
    ex, session, spans, _ = loop
    trials = [s for s in spans if s.name == "executor.trial"]
    total = 0.0
    for s in trials:
        total += s.end - s.start
    assert ex.measure_seconds == total
    assert ex.measured == sum(s.attrs["candidates"] for s in trials)
    d = [s for s in spans if s.name == "analyse.discover"][-1]
    t = [s for s in spans if s.name == "analyse.train"][-1]
    assert session._last_analysis_seconds == \
        (d.end - d.start) + (t.end - t.start)
    # one engine call: its report's timings are its spans' durations
    engine, _, _ = _stack()
    T.reset()
    rep = engine.serve(batch=2, prompt_len=16, gen=3)
    got = {s.name: s for s in T.snapshot()}
    assert rep.prefill_s == got["engine.prefill"].seconds
    assert rep.decode_s == got["engine.decode"].seconds
    assert got["engine.decode"].attrs["steps"] == rep.steps == 3
    call = got["engine.serve"]
    assert call.attrs["purpose"] == "serve"
    assert T.trace_us(call.start, call) == call.attrs["unix_ns"] / 1e3
    assert abs(call.attrs["unix_ns"] / 1e9 - time.time()) < 60


def test_warm_and_calibrate_purposes(loop):
    ex, _, spans, _ = loop
    serves = sorted((s for s in spans if s.name == "engine.serve"),
                    key=lambda s: s.id)
    purposes = collections.Counter(s.attrs["purpose"] for s in serves)
    assert purposes["warm"] == len(ex._warm)
    warm = collections.Counter((s.attrs["batch"], s.attrs["prompt"],
                                s.attrs["capacity"]) for s in serves
                               if s.attrs["purpose"] == "warm")
    assert warm == collections.Counter((b, p, cap)
                                       for _, b, p, cap in ex._warm)
    # _calibrate: the first window's unit, two serves at the initial batch
    # and the window's longest prompt and output, the first warmed
    first = ex.windows[0]
    cal = [s for s in serves if s.attrs["purpose"] == "calibrate"]
    assert len(cal) == 2
    for s in cal:
        assert (s.attrs["batch"], s.attrs["prompt"], s.attrs["steps"]) == \
            (INITIAL.serve_batch, int(first.prompt_len.max()),
             int(first.gen.max()))
    assert [s.attrs["purpose"] for s in serves[:3]] == \
        ["warm", "calibrate", "calibrate"]
    (pf,) = _children(spans, cal[1], "engine.prefill")
    (dc,) = _children(spans, cal[1], "engine.decode")
    assert ex._unit == (pf.seconds + dc.seconds) / INITIAL.serve_batch


def test_ring_bound_and_dropped():
    T.reset()
    for i in range(T.CAPACITY + 7):
        T.span("s", i=i).close()
    got = T.snapshot()
    assert len(got) == T.CAPACITY and T.dropped == 7
    assert got[0].attrs["i"] == 7 and got[-1].attrs["i"] == T.CAPACITY + 6
    T.reset()
    assert T.snapshot() == [] and T.dropped == 0


class _Clock:
    """``time.perf_counter`` that moves only inside the model's prefill
    and decode, so two runs read the same times."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _clocked_run(monkeypatch):
    clock = _Clock()
    real_prefill, real_decode = M.prefill, M.decode

    def prefill(params, cfg, batch, tun, cache=None):
        clock.t += 1e-5 * batch["tokens"].numel()
        return real_prefill(params, cfg, batch, tun, cache=cache)

    def decode(params, cfg, batch, cache, tun):
        clock.t += 1e-3 + 1e-4 * batch["tokens"].shape[0]
        return real_decode(params, cfg, batch, cache, tun)
    with monkeypatch.context() as m:
        m.setattr(M, "prefill", prefill)
        m.setattr(M, "decode", decode)
        m.setattr(time, "perf_counter", clock)
        ex, session, final = _run(windows=(8, 8))
    return (final, [(e.window_id, str(e.kind), e.label, e.tunables)
                    for e in session.events],
            ex.window_log, ex.request_latencies, ex.measure_seconds)


def test_disabled_records_nothing_and_changes_no_output(monkeypatch):
    T.reset()
    on = _clocked_run(monkeypatch)
    assert len(T.snapshot()) > 0
    T.reset()
    monkeypatch.setattr(T, "enabled", False)
    off = _clocked_run(monkeypatch)
    assert T.snapshot() == [] and T.dropped == 0
    assert on == off
    engine, _, _ = _stack()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        rep = engine.serve(batch=2, prompt_len=16, gen=3)
    assert T.snapshot() == []
    monkeypatch.setattr(T, "enabled", True)
    again = engine.serve(batch=2, prompt_len=16, gen=3)
    np.testing.assert_array_equal(rep.generated, again.generated)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_detail_spans_only_under_a_profiler(arch):
    from torch.profiler import ProfilerActivity, profile, schedule
    engine, _, _ = _stack(arch)
    cfg = engine.cfg
    T.reset()
    plain = engine.serve(batch=2, prompt_len=16, gen=3)
    assert not DETAIL & {s.name for s in T.snapshot()}
    T.reset()
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        engine.serve(batch=2, prompt_len=16, gen=2)      # warm-up step
        prof.step()
        rep = engine.serve(batch=2, prompt_len=16, gen=3)
        prof.step()
    np.testing.assert_array_equal(rep.generated, plain.generated)
    spans = T.snapshot()
    by_id = _by_id(spans)
    calls = [s for s in spans if s.name == "engine.serve"]
    assert len(calls) == 2
    for call, steps in zip(calls, (0, 3)):        # none in the warm-up
        inside = [s for s in spans if s.name in DETAIL
                  and call.start <= s.start <= call.end]
        names = collections.Counter(s.name for s in inside)
        if not steps:
            assert not names
            continue
        assert names == {"engine.step": steps, "engine.sample": steps,
                         "model.embed": steps, "model.views": steps,
                         "model.head": steps,
                         "model.layer": steps * cfg.n_layers}
        for s in inside:
            parent = by_id[s.parent].name
            assert parent == ("engine.decode" if s.name == "engine.step"
                              else "engine.step")
        layers = [s.attrs["index"] for s in inside
                  if s.name == "model.layer"]
        assert layers == list(range(cfg.n_layers)) * steps
