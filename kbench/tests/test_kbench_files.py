"""A cell, a mix and a per-layer metric added from files alone, in a
temporary folder: the harness finds them by name."""
import json
import time

import pytest
import torch

from kbench import harness
from kbench.tests import tiny


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One torch thread while a window runs (six test workers share the
    cores), restored after; and the run's import rule left to
    ``test_kbench_imports.py``, since a test worker also runs the files
    that load the JAX package."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_new_cell_mix_and_metric_from_files(tmp_path):
    mix = dict(tiny.MIX, prompt={"buckets": [24], "weights": [1]},
               phases=[{"name": "only", "gap": 2.0, "windows": 3}])
    root = tiny.make_root(tmp_path, ("qwen2",), mix=mix)
    (root / "kbench" / "metrics" / "committed_calls.py").write_text(
        "def read(run):\n    return float(len(run['measured']))\n")
    (root / "kbench" / "metrics" / "silent_share.py").write_text(
        "def read(run):\n    return None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"] += [
        {"name": "committed_calls", "unit": "calls", "better": "higher",
         "source": "program_span", "layer": "serving engine",
         "moves": "served_tokens_per_s", "workloads": ["tiny-qwen2.mix"]},
        {"name": "silent_share", "unit": "%", "better": "higher",
         "source": "program_span", "layer": "serving engine",
         "moves": "served_tokens_per_s"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    quiet = dict(device="cpu", log=lambda *a, **k: None)
    res = harness.measure(root, "tiny-qwen2.mix", 77, 1.0, True,
                          time.perf_counter(), **quiet)
    assert res["correct"], res["checks"]
    assert res["metrics"]["committed_calls"]["value"] >= 1
    assert "silent_share" not in res["metrics"]
    assert "flash_roofline" not in res["metrics"]       # no trace on the CPU
    assert {"decode_step_ms", "prefill_ms_per_ktok", "trial_share",
            "kermit_host_share"} <= set(res["metrics"])
    res = harness.measure(root, "tiny-qwen2.mix", 77, 1.0, False,
                          time.perf_counter(), **quiet)
    assert set(res["metrics"]) == {"request_p95_s", "served_tokens_per_s",
                                   "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
