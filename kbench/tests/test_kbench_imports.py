"""The import rule: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro``, compared whole, in what the benchmark runs; and
the entry's refusals."""
import json
import os
import subprocess
import sys
import types

from kbench import harness
from kbench.tests.tiny import REPO


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.kermit", "jaxtyping",
                 "flaxen", "reprox"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    base = set(harness.forbidden_modules())
    assert not {"repro_torch", "jaxtyping", "flaxen", "reprox"} & base
    for name, top in (("repro.core.dbscan", "repro"), ("jaxlib.xla", "jaxlib"),
                      ("jax", "jax"), ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert top in harness.forbidden_modules()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_a_cpu_run_loads_none_of_them(tmp_path):
    code = f"""
import json, sys, time, pathlib
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
import torch; torch.set_num_threads(1)
from kbench import harness
from kbench.tests import tiny
root = tiny.make_root(pathlib.Path({str(tmp_path)!r}), ("qwen2", "mamba2"))
for w in ("tiny-qwen2.mix", "tiny-mamba2.mix"):
    harness.measure(root, w, 11, 0.5, False, time.perf_counter(),
                    device="cpu", log=lambda *a, **k: None)
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_run_refuses_without_cuda():
    out = subprocess.run(
        [sys.executable, str(REPO / "kbench" / "run.py"), "--workload",
         "qwen2-1.5b.code", "--seed", "3", "--seconds", "1"],
        capture_output=True, text=True, env={**_env(),
                                            "CUDA_VISIBLE_DEVICES": ""},
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and ``kbench`` cannot
    build the system under test."""
    import shutil
    shutil.copytree(REPO / "kbench", tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}]\n"
            "from kbench import harness\n"
            f"harness.Bench(__import__('pathlib').Path({str(tmp_path)!r}), "
            "'qwen2-1.5b.code', 'cpu')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and "repro_torch" in out.stderr
