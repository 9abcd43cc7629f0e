"""The program's own spans against the benchmark's frozen copy of its
chunking: in a tiny cell's window, the ``executor.chunk`` spans put
every committed request on the engine call that ``replay.mark_window``
finds for it."""
import pytest
import torch

from kbench import harness, spans
from kbench.tests import tiny
from repro_torch.runtime import trace


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family", ["qwen2", "mamba2"])
def test_chunk_spans_match_mark_window(tmp_path, family):
    trace.reset()
    root = tiny.make_root(tmp_path, (family,))
    bench = harness.Bench(root, f"tiny-{family}.mix", "cpu")
    seed = 2 ** 31 + 11
    bench.prepare(seed)
    out = bench.run(seed, 1.0, False)
    rec = out["rec"]
    _, inside = spans.run_spans()
    serves = [s for s in inside if s.name == "engine.serve"]
    # one engine.serve span for each call the benchmark's wrapper saw,
    # in the same order
    assert [(s.attrs["batch"], s.attrs["prompt"]) for s in serves] == \
        [(c["batch"], c["prompt"]) for c in rec.calls]
    index = {s.id: j for j, s in enumerate(serves)}
    windows = [s for s in inside if s.name == "executor.window"]
    assert len(windows) == len(rec.windows) >= 2
    committed = 0
    for w, span in zip(rec.windows, windows):
        assert span.attrs["window"] == int(w["win"].index)
        chunks = [s for s in inside if s.name == "executor.chunk"
                  and s.parent == span.id]
        assert len(chunks) == len(w["chunks"])
        for chunk, j in zip(chunks, w["chunks"]):
            (served,) = [s for s in serves if s.parent == chunk.id
                         and s.attrs["purpose"] == "serve"]
            assert index[served.id] == j
            assert chunk.attrs["requests"] == rec.calls[j]["requests"].tolist()
            assert chunk.attrs["real_rows"] == rec.calls[j]["real_rows"]
            committed += chunk.attrs["real_rows"]
    assert committed == sum(len(w["win"]) for w in rec.windows)
    # and no call the benchmark did not mark served a committed chunk
    marked = {j for w in rec.windows for j in w["chunks"]}
    for j, s in enumerate(serves):
        parent = next((p for p in inside if p.id == s.parent), None)
        if (s.attrs["purpose"] == "serve" and parent is not None
                and parent.name == "executor.chunk"
                and any(parent.parent == w.id for w in windows)):
            assert j in marked
