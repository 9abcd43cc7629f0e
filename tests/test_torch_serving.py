"""Autonomic serving (``repro_torch.kermit.serving``) against the JAX
package: traffic, percentile, the engine on converted weights, the
executor under one deterministic clock, and the closed night -> day loop.

Both engines hold the same weights and prompt tokens.  Wall-clock timings
differ between any two runs, so the executor and loop tests give both
engines' ``serve`` the same deterministic timings (``fixed_timings``):
latencies, costs, window logs and telemetry then agree bit for bit, and
with the reference's random draws injected (``reference_draws``) the
loop's events, RETUNE stream and final Tunables do too.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import Tunables as JTunables
from repro.kermit import (AnalysisConfig as JAnalysisConfig,
                          KermitConfig as JKermitConfig,
                          KermitSession as JKermitSession,
                          KnowledgeConfig as JKnowledgeConfig,
                          MonitorConfig as JMonitorConfig,
                          PlanConfig as JPlanConfig)
from repro.kermit import serving as JS
from repro.runtime.telemetry import percentile as j_percentile
from repro_torch.configs.base import Tunables
from repro_torch.convert import model_params_from_jax
from repro_torch.kermit import (AnalysisConfig, EventKind, KermitConfig,
                                KermitSession, KnowledgeConfig,
                                MonitorConfig, PlanConfig)
from repro_torch.kermit import serving as PS
from repro_torch.runtime.telemetry import percentile
from torch_parity import reference_draws  # noqa: F401 (fixture)

INITIAL = dict(serve_batch=4, cache_len=32)
WINDOW_FIELDS = ("index", "phase", "phase_index", "gap")
ARRAY_FIELDS = ("arrivals", "tenant", "prompt_len", "gen")


def fixed_timings(engine, report_cls):
    """Replace ``engine.serve``'s measured timings with a deterministic
    model of batch size, prompt length and decode steps (the same Python
    floats in both packages); the model still runs and decodes."""
    real = engine.serve

    def serve(**kw):
        rep = real(**kw)
        return report_cls(
            batch=rep.batch, prompt_len=rep.prompt_len, gen=rep.gen,
            capacity=rep.capacity,
            prefill_s=1e-3 + 2e-5 * rep.batch * rep.prompt_len,
            decode_s=rep.steps * (5e-4 + 5e-5 * rep.batch),
            steps=rep.steps, generated=rep.generated)
    engine.serve = serve
    return engine


def _engines(initial, seed=0, arch="qwen2-1.5b"):
    """Reference and port engines over the same tiny weights of ``arch``;
    the port's prompt tokens are the reference's."""
    jeng = JS.ServeEngine(JS.tiny_config(arch), seed=seed,
                          initial=JTunables(**initial))
    peng = PS.ServeEngine(PS.tiny_config(arch), seed=seed,
                          initial=Tunables(**initial), device="cpu")
    peng.params = model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jeng.params), device="cpu")
    real = peng._token_batch

    def token_batch(prompt_len, batch):
        key = (prompt_len, batch)
        if key not in peng._batches:
            toks = np.asarray(jeng._token_batch(prompt_len, batch)["tokens"])
            peng._batches[key] = {"tokens": torch.tensor(toks)}
        return real(prompt_len, batch)
    peng._token_batch = token_batch
    return jeng, peng


# -- traffic and percentile ---------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda G: G.diurnal(window_size=8, seed=3),
    lambda G: G.bursty(window_size=16, seed=1, n_windows=10,
                       burstiness=0.5),
    lambda G: G.kway(("chat", "agent", "bulk"), window_size=32, seed=2,
                     n_windows=8),
])
def test_traffic_schedule_bit_identical_to_reference(make):
    want = make(JS.TrafficGenerator)
    got = make(PS.TrafficGenerator)
    assert got.phase_boundaries() == want.phase_boundaries()
    ws, gs = want.schedule(), got.schedule()
    assert len(gs) == len(ws) == got.n_windows
    for a, b in zip(gs, ws):
        for f in WINDOW_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        for f in ARRAY_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_percentile_matches_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 333):
        v = rng.exponential(size=n)
        for q in (0.0, 1.0, 50.0, 66.0, 99.0, 100.0):
            assert percentile(v, q) == j_percentile(v, q)
    assert percentile([1.0, 2.0, 10.0], 66.0) == 2.0
    with pytest.raises(ValueError):
        percentile([], 50.0)
    with pytest.raises(ValueError):
        percentile([1.0], 101.0)


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("tun", [
    dict(serve_batch=4, cache_len=32),
    dict(serve_batch=4, cache_len=0, prefill_chunk=8),
    dict(serve_batch=4, cache_len=32, cache_dtype="bfloat16"),
    dict(serve_batch=4, cache_len=32, attn_impl="pallas"),
])
def test_engine_greedy_decode_matches_reference(tun):
    jeng, peng = _engines(INITIAL)
    gen = np.array([6, 3, 5, 6])
    want = jeng.serve(batch=4, prompt_len=16, gen=gen,
                      tunables=JTunables(**tun))
    got = peng.serve(batch=4, prompt_len=16, gen=gen,
                     tunables=Tunables(**tun))
    assert got.capacity == want.capacity == (32 if tun["cache_len"] else 22)
    assert got.steps == want.steps == 6
    assert np.array_equal(got.generated, np.asarray(want.generated))
    assert got.tokens == want.tokens
    assert got.completion_s.shape == (4,)
    assert got.total_s >= float(got.completion_s.max()) > 0.0
    # a repeated configuration reuses its cached steps
    before = dict(peng.stats)
    again = peng.serve(batch=4, prompt_len=16, gen=gen,
                       tunables=Tunables(**tun))
    assert np.array_equal(again.generated, got.generated)
    assert peng.stats["prefill_builds"] == before["prefill_builds"]
    assert peng.stats["decode_builds"] == before["decode_builds"]
    assert peng.stats["serve_calls"] == before["serve_calls"] + 1


@pytest.mark.parametrize("tun", [
    dict(cache_len=32, attn_impl="pallas", ssm_chunk=8),
    dict(cache_len=0, cache_dtype="bfloat16"),
])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_ssm_engine_greedy_decode_matches_reference(arch, tun):
    """The SSM families through both engines: a 16-token prompt over
    chunks of 8 on the pallas route (the reference's kernel in interpret
    mode), and a bf16 KV cache, which only zamba2's attention has."""
    jeng, peng = _engines(INITIAL, arch=arch)
    gen = np.array([5, 2, 4, 5])
    want = jeng.serve(batch=4, prompt_len=16, gen=gen,
                      tunables=JTunables(**tun))
    got = peng.serve(batch=4, prompt_len=16, gen=gen,
                     tunables=Tunables(**tun))
    assert got.capacity == want.capacity == (32 if tun["cache_len"] else 21)
    assert got.steps == want.steps == 5
    assert np.array_equal(got.generated, np.asarray(want.generated))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_cache_dtype_leaves_the_ssm_states_alone(arch, monkeypatch):
    """``cache_dtype`` casts only attention keys and values, as the
    reference's cache growth does (names k/v/k0/v0): SSM states stay
    fp32, conv rows in the model dtype; prefill fills them in place."""
    from repro_torch.models import model as M
    _, peng = _engines(INITIAL, arch=arch)
    seen = []
    real = M.init_cache

    def spy(cfg, batch, seq, dtype=None, device=None):
        cache = real(cfg, batch, seq, dtype=dtype, device=device)
        seen.append(cache)
        return cache
    monkeypatch.setattr(M, "init_cache", spy)
    peng.serve(batch=2, prompt_len=16, gen=3,
               tunables=Tunables(cache_len=32, cache_dtype="bfloat16"))
    (cache,) = seen
    states = [cache] if arch.startswith("mamba") else [cache["g_ssm"],
                                                       cache["r_ssm"]]
    for st in states:
        assert st["ssm"].dtype == torch.float32 and st["ssm"].abs().sum() > 0
        assert st["conv"].dtype == torch.float32 and st["conv"].abs().sum() > 0
    if arch.startswith("zamba"):
        assert cache["k"].dtype == cache["v"].dtype == torch.bfloat16
        assert cache["k"].shape[2] == 32                 # capacity
        assert cache["k"][:, :, :19].abs().sum(dim=(0, 1, 3, 4)).all()
        assert not cache["k"][:, :, 19:].any()
    else:
        assert set(cache) == {"ssm", "conv"}


def test_engine_cache_is_allocated_at_capacity_in_cache_dtype(monkeypatch):
    from repro_torch.models import model as M
    _, peng = _engines(INITIAL)
    seen = []
    real = M.init_cache

    def spy(cfg, batch, seq, dtype=None, device=None):
        cache = real(cfg, batch, seq, dtype=dtype, device=device)
        seen.append(cache)
        return cache
    monkeypatch.setattr(M, "init_cache", spy)
    peng.serve(batch=2, prompt_len=16, gen=5,
               tunables=Tunables(cache_len=32, cache_dtype="bfloat16"))
    (cache,) = seen
    assert cache["k"].shape == (2, 2, 32, 2, 32)       # (L, B, cap, K, hd)
    assert cache["k"].dtype == torch.bfloat16
    assert cache["k"][:, :, :21].abs().sum(dim=(0, 1, 3, 4)).all()
    assert not cache["k"][:, :, 21:].any()


def test_get_engine_is_lru_bounded_and_cuda_by_default():
    cfg = PS.tiny_config("qwen2-1.5b")
    a = PS.get_engine(cfg, 0, device="cpu")
    assert PS.get_engine(cfg, 0, device="cpu") is a
    PS.get_engine(cfg, 1, device="cpu", max_engines=1)
    assert PS.get_engine(cfg, 0, device="cpu") is not a
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PS.ServeEngine(cfg)


# -- the executor under one clock ---------------------------------------------


def _executors(traffic_kw, initial=INITIAL, config_kw=None,
               arch="qwen2-1.5b"):
    jeng, peng = _engines(initial, arch=arch)
    fixed_timings(jeng, JS.engine.ServeReport)
    fixed_timings(peng, PS.engine.ServeReport)
    make = traffic_kw.pop("make")
    jx = JS.ServeExecutor(jeng, make(JS.TrafficGenerator, **traffic_kw),
                          config=JS.ServeConfig(**(config_kw or {})),
                          initial=JTunables(**initial))
    px = PS.ServeExecutor(peng, make(PS.TrafficGenerator, **traffic_kw),
                          config=PS.ServeConfig(**(config_kw or {})),
                          initial=Tunables(**initial))
    return jx, px


def test_executor_stats_and_telemetry_bit_identical_to_reference():
    jx, px = _executors(dict(make=lambda G, **kw: G.kway(("chat", "agent"),
                                                         **kw),
                             window_size=6, seed=1, n_windows=3, gap=1.0),
                        config_kw=dict(window_size=6, probe_repeats=2))
    for win_j, win_p in zip(jx.windows, px.windows):
        assert np.array_equal(jx.serve_window(win_j), px.serve_window(win_p))
    assert px.window_log == jx.window_log
    assert px.request_latencies == jx.request_latencies
    assert px._unit == jx._unit
    for t in ({"serve_batch": 2}, {"serve_batch": 8, "cache_len": 64}):
        want = jx.probe_stats(JTunables(**t))
        got = px.probe_stats(Tunables(**t))
        assert np.array_equal(got.pop("latencies"), want.pop("latencies"))
        assert got == want
    costs = px.measure_batch([Tunables(serve_batch=2), Tunables()])
    assert costs == jx.measure_batch([JTunables(serve_batch=2), JTunables()])
    assert px.current == Tunables(**INITIAL)          # probes move nothing

    state = px.export_state()
    assert state == jx.export_state() | {"measure_seconds":
                                         state["measure_seconds"]}
    fresh = PS.ServeExecutor(px.engine, px.traffic, config=px.config)
    fresh.restore_state(state)
    assert fresh.export_state() == state
    assert fresh.current == px.current


def test_serve_config_round_trip_and_from_config():
    sc = PS.ServeConfig(probe_repeats=3, tail_weight=0.25)
    assert PS.ServeConfig.from_dict(sc.to_dict()) == sc
    assert sc.to_dict() == JS.ServeConfig(probe_repeats=3,
                                          tail_weight=0.25).to_dict()
    with pytest.raises(ValueError, match="unknown ServeConfig"):
        PS.ServeConfig.from_dict({"archs": "typo"})
    ex = PS.ServeExecutor.from_config(PS.ServeConfig(window_size=4),
                                      device="cpu")
    assert ex.engine.device.type == "cpu" and len(ex.windows) == 32
    assert PS.SERVE_SPACE == JS.SERVE_SPACE


# -- the closed loop: night -> day re-plan ---------------------------------------


def _loop_config(pkg, initial, space):
    Kc, Mc, Ac, Nc, Pc = pkg
    return Kc(monitor=Mc(window_size=8),
              analysis=Ac(interval=6, min_windows=6),
              knowledge=Nc(drift_eps=0.45),
              plan=Pc(space=space, default_tunables=initial))


# per served model: the initial Tunables and the Plan space of the loop
# (qwen2: tests/test_serving_autonomic.py; mamba2: the SSM serving path,
# chunks of 16 so every 48-token day prefill carries state across 3)
LOOPS = {
    "qwen2-1.5b": (dict(serve_batch=8, cache_len=64),
                   {"serve_batch": [2, 4, 8], "cache_len": [64]}),
    "mamba2-1.3b": (dict(serve_batch=8, cache_len=64, ssm_chunk=16,
                         attn_impl="pallas"),
                    {"serve_batch": [2, 4, 8], "ssm_chunk": [16]}),
}


def _run_loop(session_cls, config, ex, **kw):
    events = []
    with session_cls(config, executor=ex, **kw) as session:
        session.subscribe(None, events.append)
        final = session.run_live(ex.telemetry_stream())
    return final, [(e.window_id, str(e.kind), e.label, e.tunables,
                    {k: v for k, v in e.detail.items() if "second" not in k})
                   for e in events]


@pytest.mark.parametrize("arch", sorted(LOOPS))
def test_autonomic_replan_matches_reference(reference_draws, arch):
    """tests/test_serving_autonomic.py's night -> day gate, through both
    packages under one clock: the port re-plans where the reference does,
    with the same events, RETUNE stream and final Tunables."""
    initial, space = LOOPS[arch]
    jx, px = _executors(dict(make=lambda G, **kw: G.diurnal(**kw),
                             window_size=8, seed=0, night_windows=12,
                             day_windows=12),
                        initial=initial, config_kw=dict(probe_repeats=3),
                        arch=arch)
    jfinal, jevents = _run_loop(
        JKermitSession, _loop_config((JKermitConfig, JMonitorConfig,
                                      JAnalysisConfig, JKnowledgeConfig,
                                      JPlanConfig), initial, space), jx)
    final, events = _run_loop(
        KermitSession, _loop_config((KermitConfig, MonitorConfig,
                                     AnalysisConfig, KnowledgeConfig,
                                     PlanConfig), initial, space), px,
        device="cpu")
    assert final.as_dict() == jfinal.as_dict()
    assert events == jevents
    assert px.window_log == jx.window_log

    wl = px.window_log
    change_w = px.traffic.phase_boundaries()[0]
    changes = [wl[i]["window"] for i in range(1, len(wl))
               if wl[i]["tunables"] != wl[i - 1]["tunables"]]
    replans = [w for w in changes if w >= change_w]
    kinds = {e[1] for e in events}
    assert replans, changes
    assert {EventKind.DRIFT.value, EventKind.RETUNE.value} <= kinds
    w0 = replans[0]
    p99_before = np.median([w["p99"] for w in wl
                            if change_w <= w["window"] < w0])
    p99_after = np.median([w["p99"] for w in wl if w["window"] >= w0])
    assert p99_after <= p99_before
    assert final == px.current
