"""``ServeEngine`` on the moe, vlm and encdec families against the JAX
package's engine: the same tiny weights and prompts (patches and frames
included), greedy tokens and capacity equal; and one night -> day
``KermitSession`` + ``ServeExecutor`` loop on tiny deepseek-moe-16b under
one deterministic clock, bit-equal events with the reference's draws
injected.

The port allocates the cache once where the reference pads its prefill
cache; for encdec that padding is of the decoder's ``prompt_len // 2``
positions, and decode writes at ``prompt_len + i``, past them: the
reference's ``dynamic_update_slice`` clamps those writes to the last
slot, and the port must do the same (ROADMAP C20).
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
from repro_torch.configs.base import Tunables
from repro_torch.convert import model_params_from_jax
from repro_torch.kermit import (AnalysisConfig, EventKind, KermitConfig,
                                KermitSession, KnowledgeConfig,
                                MonitorConfig, PlanConfig)
from repro_torch.kermit import serving as PS
from test_torch_serving import _loop_config, _run_loop, fixed_timings
from torch_parity import reference_draws  # noqa: F401 (fixture)

MOE, VLM, ENCDEC = "deepseek-moe-16b", "paligemma-3b", "seamless-m4t-large-v2"


def _engines(arch, initial, seed=0):
    """Reference and port engines over the same tiny weights of ``arch``;
    the port's prompt batch (tokens, and patches or frames) is the
    reference's."""
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
            real(prompt_len, batch)               # the port's own checks
            peng._batches[key] = {
                k: torch.tensor(np.asarray(v)) for k, v in
                jeng._token_batch(prompt_len, batch).items()}
        return peng._batches[key]
    peng._token_batch = token_batch
    return jeng, peng


@pytest.mark.parametrize("arch,prompt,gen,tun", [
    (MOE, 16, [6, 3, 5, 6], dict(cache_len=32)),
    (MOE, 16, [6, 3, 5, 6], dict(cache_len=32, attn_impl="pallas",
                                 cache_dtype="bfloat16")),
    (VLM, 24, [6, 3, 5, 6], dict(cache_len=32)),
    (VLM, 24, [6, 3, 5, 6], dict(cache_len=0, attn_impl="pallas")),
    # every decode write past the decoder's 24 + 6 - 1 slots: clamped
    (ENCDEC, 48, [6, 6, 6, 6], dict(cache_len=0)),
    # capacity 32: 8 + 16 self positions, writes at 16..21 land in place,
    # and slots 8..15 stay zero but unmasked, in both packages
    (ENCDEC, 16, [6, 2, 4, 6], dict(cache_len=32, cache_dtype="bfloat16")),
])
def test_engine_greedy_decode_matches_reference(arch, prompt, gen, tun):
    jeng, peng = _engines(arch, dict(serve_batch=4, cache_len=32))
    gen = np.array(gen)
    want = jeng.serve(batch=4, prompt_len=prompt, gen=gen,
                      tunables=JTunables(**tun))
    got = peng.serve(batch=4, prompt_len=prompt, gen=gen,
                     tunables=Tunables(**tun))
    assert got.capacity == want.capacity
    assert got.steps == want.steps == 6
    assert np.array_equal(got.generated, np.asarray(want.generated))
    assert got.tokens == want.tokens


def test_encdec_serve_cache_matches_the_reference_padding(monkeypatch):
    """Prompt 48, 6 new tokens, exact capacity: the self-attention cache
    has 24 + 6 positions (the reference pads the decoder's 24 by 6) in
    ``cache_dtype``, the cross-attention cache the memory's 24 in the
    model dtype; every decode step writes the last slot."""
    from repro_torch.models import model as M
    _, peng = _engines(ENCDEC, dict(serve_batch=2, cache_len=0))
    seen = []
    real = M.init_cache

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(M, "init_cache", spy)
    rep = peng.serve(batch=2, prompt_len=48, gen=6,
                     tunables=Tunables(cache_len=0, cache_dtype="bfloat16"))
    (cache,) = seen
    assert rep.capacity == 54
    assert cache["k"].shape == (2, 2, 30, 2, 32)     # (L, B, 24 + 6, K, hd)
    assert cache["xk"].shape == (2, 2, 24, 2, 32)
    assert cache["k"].dtype == torch.bfloat16
    assert cache["xk"].dtype == torch.float32
    filled = cache["k"].abs().sum(dim=(0, 1, 3, 4)) > 0
    assert filled[:24].all() and not filled[24:29].any() and filled[29]


def test_vlm_prompt_must_exceed_the_patches():
    _, peng = _engines(VLM, dict(serve_batch=2, cache_len=32))
    with pytest.raises(ValueError, match="patches"):
        peng.serve(batch=2, prompt_len=8, gen=2)
    rep = peng.serve(batch=2, prompt_len=9, gen=2)   # one text token
    assert rep.generated.shape == (2, 3)


def test_moe_autonomic_replan_matches_reference(reference_draws):
    """tests/test_serving_autonomic.py's night -> day gate on tiny
    deepseek-moe-16b, through both packages under one clock: the port
    re-plans where the reference does, with the same events, RETUNE
    stream and final Tunables."""
    initial = dict(serve_batch=8, cache_len=64)
    space = {"serve_batch": [2, 4, 8], "cache_len": [64]}
    jeng, peng = _engines(MOE, initial)
    fixed_timings(jeng, JS.engine.ServeReport)
    fixed_timings(peng, PS.engine.ServeReport)
    # chip_smoke.py's serving schedule: the fewest windows that still
    # show the day's DRIFT, its re-plan and two windows after it
    kw = dict(window_size=8, seed=0, night_windows=8, day_windows=12)
    jx = JS.ServeExecutor(jeng, JS.TrafficGenerator.diurnal(**kw),
                          config=JS.ServeConfig(probe_repeats=3),
                          initial=JTunables(**initial))
    px = PS.ServeExecutor(peng, PS.TrafficGenerator.diurnal(**kw),
                          config=PS.ServeConfig(probe_repeats=3),
                          initial=Tunables(**initial))
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
    kinds = {e[1] for e in events}
    assert {EventKind.DRIFT.value, EventKind.RETUNE.value} <= kinds
    change_w = px.traffic.phase_boundaries()[0]
    wl = px.window_log
    replans = [wl[i]["window"] for i in range(change_w, len(wl))
               if wl[i]["tunables"] != wl[i - 1]["tunables"]]
    assert replans and replans[0] < len(wl) - 1, replans
    before = np.median([w["p99"] for w in wl
                        if change_w <= w["window"] < replans[0]])
    after = np.median([w["p99"] for w in wl if w["window"] >= replans[0]])
    assert after <= before
