"""The decode graph of ``ServeEngine.serve`` on the card, against the
eager loop at the same weights: greedy tokens from replay equal the
eager loop's for tiny qwen2 and mamba2 at batches 2 and 8, over two
prompt lengths, in fp32 and bf16; a second serve of one key captures
nothing; serves of keys A, B, A give A's tokens both times (the static
caches do not leak into each other); new parameters drop the graphs; a
call made while a profiler records captures nothing, replays only a
graph captured before and records no detail spans when it replays; at most ``_DECODE_GRAPHS_MAX`` graphs are kept.
Marked ``cuda``: skips where there is no GPU.  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_decode_graph_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kermit.serving import ServeEngine, tiny_config
from repro_torch.kermit.serving import engine as E
from repro_torch.runtime import trace as T

pytestmark = pytest.mark.cuda

ARCHS = ["qwen2-1.5b", "mamba2-1.3b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    return torch.device("cuda")


def _pair(arch, dtype, seed=0):
    """(an engine that replays, one at the same weights that does not)."""
    eng = ServeEngine(tiny_config(arch, dtype=dtype), seed=seed,
                      device="cuda")
    eager = ServeEngine(tiny_config(arch, dtype=dtype), seed=seed,
                        device="cuda")
    eager.params = eng.params
    eager._graphed = lambda steps: False
    return eng, eager


def _serve(eng, batch, prompt, gen=7):
    return eng.serve(batch=batch, prompt_len=prompt, gen=gen).generated


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_replay_gives_the_eager_loops_tokens(cuda_device, arch, dtype):
    eng, eager = _pair(arch, dtype)
    for batch in (2, 8):
        for prompt in (16, 40):
            want = _serve(eager, batch, prompt)
            got = _serve(eng, batch, prompt)
            assert np.array_equal(got, want), (batch, prompt)
    assert eng.stats["decode_graph_captures"] == (4 if arch == "qwen2-1.5b"
                                                  else 2)
    assert eng.stats["decode_graph_steps"] == 4 * 7
    assert eager.stats["decode_graph_captures"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_a_second_serve_of_a_key_captures_nothing(cuda_device, arch):
    eng, _ = _pair(arch, "float32")
    first = _serve(eng, 4, 24)
    assert eng.stats["decode_graph_captures"] == 1
    again = _serve(eng, 4, 24)
    assert eng.stats["decode_graph_captures"] == 1
    assert np.array_equal(first, again)
    spans = [s for s in T.snapshot() if s.name == "engine.capture"]
    assert spans and spans[-1].attrs == {"batch": 4, "capacity": 31}


@pytest.mark.parametrize("arch", ARCHS)
def test_keys_a_b_a_do_not_leak(cuda_device, arch):
    eng, eager = _pair(arch, "float32")
    a1 = _serve(eng, 2, 32)
    b = _serve(eng, 8, 16)
    a2 = _serve(eng, 2, 32)
    assert np.array_equal(a1, a2)
    assert np.array_equal(a1, _serve(eager, 2, 32))
    assert np.array_equal(b, _serve(eager, 8, 16))
    assert eng.stats["decode_graph_captures"] == 2


def test_new_parameters_drop_the_graphs(cuda_device):
    eng, eager = _pair("qwen2-1.5b", "float32")
    before = _serve(eng, 2, 16)
    new = ServeEngine(tiny_config("qwen2-1.5b"), seed=1, device="cuda")
    eng.params = eager.params = new.params
    after = _serve(eng, 2, 16)
    assert eng.stats["decode_graph_captures"] == 2
    assert np.array_equal(after, _serve(eager, 2, 16))
    assert not np.array_equal(after, before)


def test_no_capture_while_a_profiler_records(cuda_device):
    from torch.profiler import ProfilerActivity, profile
    eng, eager = _pair("mamba2-1.3b", "float32")
    T.reset()
    with profile(activities=[ProfilerActivity.CUDA]):
        cold = _serve(eng, 2, 16)
    assert eng.stats["decode_graph_captures"] == 0
    _serve(eng, 4, 16)                       # captures the batch-4 key
    with profile(activities=[ProfilerActivity.CUDA]):
        warm = _serve(eng, 4, 16)
    assert eng.stats["decode_graph_captures"] == 1
    assert np.array_equal(cold, _serve(eager, 2, 16))
    assert np.array_equal(warm, _serve(eager, 4, 16))
    decodes = [s for s in T.snapshot() if s.name == "engine.decode"]
    assert [s.attrs["graph"] for s in decodes[:3]] == [False, True, True]
    # the profiled calls: the eager one records its detail spans, the
    # replayed one none
    inner = [[s.name for s in T.snapshot() if s.parent == d.id]
             for d in (decodes[0], decodes[2])]
    assert inner[0] == ["engine.step"] * 7 and inner[1] == []


def test_graphs_are_bounded(cuda_device, monkeypatch):
    monkeypatch.setattr(E, "_DECODE_GRAPHS_MAX", 2)
    eng, eager = _pair("mamba2-1.3b", "float32")
    for batch in (2, 4, 8):
        _serve(eng, batch, 16)
    assert len(eng._graphs) == 2
    got = _serve(eng, 2, 16)                 # evicted: captured again
    assert eng.stats["decode_graph_captures"] == 4
    assert np.array_equal(got, _serve(eager, 2, 16))
