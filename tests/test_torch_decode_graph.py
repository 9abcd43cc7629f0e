"""The decode step's capture-safe form and the serving engine's choice of
the decode graph, on the CPU.

Every family's decode step (``decode_step`` for dense, moe and vlm,
``decode_mamba``, ``decode_zamba``, the encdec step) with ``pos`` as a
0-dim int64 tensor gives logits and caches equal, bit for bit, to
``pos`` as an int, step after step, encdec's clamped writes included.
``models/model.FAMILIES`` replays the dense and ssm steps only.
``ServeEngine.decode_graph_key`` holds only what a captured step depends
on: the batch, the cache's shapes and dtype and the Tunables fields the
step reads (not ``prefill_chunk``, not ``attn_q_chunk``).  On the CPU,
and for a one-step call, no graph is captured and the eager loop runs
(``tests/test_torch_decode_graph_cuda.py`` holds the replay itself on
the card).
"""
import pytest
import torch

from repro_torch.configs.base import ShapeSpec, Tunables
from repro_torch.kermit.serving import ServeEngine, tiny_config
from repro_torch.models import encdec as ED
from repro_torch.models import model as M
from repro_torch.models import ssm_lm as S
from repro_torch.models import transformer as TR
from repro_torch.runtime import trace as T

TUN = Tunables()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("arch,prompt", [("qwen2-1.5b", 12),
                                         ("mamba2-1.3b", 12),
                                         ("paligemma-3b", 20),
                                         ("deepseek-moe-16b", 12),
                                         ("zamba2-7b", 12),
                                         ("seamless-m4t-large-v2", 12)])
def test_tensor_pos_equals_int_pos_bit_for_bit(arch, prompt):
    cfg = tiny_config(arch)
    gen = torch.Generator().manual_seed(3)
    params = M.init(gen, cfg)
    # norm offsets and biases start at 0: move them so they reach the logits
    for p in _leaves(params):
        p.add_(0.05 * torch.randn(p.shape, generator=gen))
    batch = M.make_batch(gen, cfg, ShapeSpec("pf", prompt, 3, "prefill"))
    # encdec: 6 tokens + 8 self positions, so pos 14 and 17 land on slot 13
    cache = M.serve_cache(cfg, 3, prompt, prompt + 8, device="cpu")
    logits, cache = M.prefill(params, cfg, batch, TUN, cache=cache)
    a, b = cache, _clone(cache)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    steps = (prompt, prompt + 1, prompt + 2, prompt + 5)
    for pos in steps:
        la, a = M.decode(params, cfg, {"tokens": tok, "pos": pos}, a, TUN)
        lb, b = M.decode(params, cfg, {"tokens": tok, "pos": torch.tensor(
            pos, dtype=torch.int64)}, b, TUN)
        assert torch.equal(la, lb)
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
        tok = torch.argmax(la[:, -1], -1)[:, None].to(torch.int32)
    # the step wrote its key and value at every position it was given,
    # clamped to the last slot
    if "k" in a:
        S = a["k"].shape[2]
        want = torch.zeros(S, dtype=torch.bool)
        want[:prompt // 2 if cfg.family == "encdec" else prompt] = True
        want[[min(pos, S - 1) for pos in steps]] = True
        assert torch.equal(a["k"].abs().sum(dim=(0, 1, 3, 4)) > 0, want)


def test_graph_key_splits_on_batch_capacity_and_what_decode_reads():
    eng = ServeEngine(tiny_config("qwen2-1.5b"), device="cpu")
    key = eng.decode_graph_key(TUN, 2, 64)
    # knobs the decode step never reads do not split graphs
    assert eng.decode_graph_key(TUN.replace(prefill_chunk=16), 2, 64) == key
    assert eng.decode_graph_key(TUN.replace(ssm_chunk=16, remat="full"),
                                2, 64) == key
    assert eng.decode_graph_key(TUN.replace(serve_batch=2), 2, 64) == key
    # one query row is one chunk: attn_q_chunk does not split the graph
    assert eng.decode_graph_key(TUN.replace(attn_q_chunk=512), 2, 64) == key
    # the batch, the capacity, the cache's dtype and what the step reads do
    assert eng.decode_graph_key(TUN, 4, 64) != key
    assert eng.decode_graph_key(TUN, 2, 128) != key
    assert eng.decode_graph_key(TUN.replace(cache_dtype="bfloat16"),
                                2, 64) != key
    # "auto" is the model's dtype: one cache, one key
    assert eng.decode_graph_key(TUN.replace(cache_dtype="float32"),
                                2, 64) == key


def test_ssm_graph_key_has_no_capacity():
    eng = ServeEngine(tiny_config("mamba2-1.3b"), device="cpu")
    key = eng.decode_graph_key(TUN, 2, 64)
    assert eng.decode_graph_key(TUN, 2, 4160) == key
    assert eng.decode_graph_key(TUN.replace(prefill_chunk=16,
                                            cache_dtype="bfloat16"),
                                2, 64) == key
    assert eng.decode_graph_key(TUN, 8, 64) != key


def test_ssm_graph_key_splits_on_attn_impl():
    # the ssm step reads attn_impl == "pallas" (the fused step kernel) and
    # nothing else of it: the other values share the plain step's graph
    eng = ServeEngine(tiny_config("mamba2-1.3b"), device="cpu")
    key = eng.decode_graph_key(TUN, 2, 64)
    pallas = eng.decode_graph_key(TUN.replace(attn_impl="pallas"), 2, 64)
    assert pallas != key
    assert eng.decode_graph_key(TUN.replace(attn_impl="pallas",
                                            ssm_chunk=16), 2, 4160) == pallas
    for impl in ("auto", "fast", "xla"):
        assert eng.decode_graph_key(TUN.replace(attn_impl=impl), 2, 64) \
            == key, impl


def test_the_family_table_replays_dense_and_ssm_only():
    rows = {"dense": (TR.init, TR.forward, TR.decode_step, TR.init_cache),
            "moe": (TR.init, TR.forward, TR.decode_step, TR.init_cache),
            "vlm": (TR.init, TR.forward, TR.decode_step, TR.init_cache),
            "ssm": (S.init_mamba, S.forward_mamba, S.decode_mamba,
                    S.cache_mamba),
            "hybrid": (S.init_zamba, S.forward_zamba, S.decode_zamba,
                       S.cache_zamba),
            "encdec": (ED.init, ED.forward, ED.decode_step, ED.init_cache)}
    assert set(M.FAMILIES) == set(rows)
    for family, fns in rows.items():
        assert M.FAMILIES[family][:4] == fns, family
    replayed = {f for f, row in M.FAMILIES.items()
                if row.graph_reads is not None}
    assert replayed == {"dense", "ssm"}
    assert M.FAMILIES["dense"].graph_reads(TUN) == ()
    assert M.FAMILIES["ssm"].graph_reads(TUN) == (False,)
    assert M.FAMILIES["ssm"].graph_reads(
        TUN.replace(attn_impl="pallas")) == (True,)


@pytest.mark.parametrize("arch,graphed", [
    ("qwen2-1.5b", True), ("mamba2-1.3b", True),
    ("deepseek-moe-16b", False), ("zamba2-7b", False),
    ("paligemma-3b", False), ("seamless-m4t-large-v2", False)])
def test_only_multi_step_dense_and_ssm_calls_on_the_card_replay(arch,
                                                                graphed):
    eng = ServeEngine(tiny_config(arch), device="cpu")
    assert not eng._graphed(2) and not eng._graphed(16)
    eng.device = torch.device("cuda")      # read, never used, here
    assert not eng._graphed(1)
    assert eng._graphed(2) is graphed and eng._graphed(16) is graphed


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_cpu_and_one_step_calls_run_the_eager_loop(arch, monkeypatch):
    eng = ServeEngine(tiny_config(arch), device="cpu")

    def refuse(*a, **kw):
        raise AssertionError("a decode graph was asked for")
    monkeypatch.setattr(eng, "_decode_graph", refuse)
    T.reset()
    one = eng.serve(batch=2, prompt_len=16, gen=1)
    many = eng.serve(batch=2, prompt_len=16, gen=[3, 5])
    assert one.generated.shape == (2, 2) and many.generated.shape == (2, 6)
    assert eng.stats["decode_graph_captures"] == 0
    assert eng.stats["decode_graph_steps"] == 0
    assert eng.stats["decode_steps"] == 6
    decodes = [s for s in T.snapshot() if s.name == "engine.decode"]
    assert [(s.attrs["steps"], s.attrs["graph"]) for s in decodes] == \
        [(1, False), (5, False)]
    assert not [s for s in T.snapshot() if s.name == "engine.capture"]
