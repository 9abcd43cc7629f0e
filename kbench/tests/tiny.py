"""A benchmark root in a temporary folder with tiny cells, for the CPU:
the repo's ``kbench`` copied beside a ``BENCHMARK.json`` whose cells
name small configurations and mixes written there, as files alone."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "qwen2": {"hidden_size": 64, "intermediate_size": 128,
              "num_hidden_layers": 2, "num_attention_heads": 2,
              "num_key_value_heads": 1, "head_dim": 32, "vocab_size": 256},
    "mamba2": {"d_model": 64, "n_layer": 2, "vocab_size": 256,
               "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "d_conv": 4,
                           "expand": 2, "headdim": 16, "ngroups": 1,
                           "chunk_size": 32}},
}
PROGRAM = {
    "qwen2": {"n_layers": 2, "d_model": 64, "n_heads": 2, "n_kv_heads": 1,
              "head_dim": 32, "d_ff": 128, "vocab": 256},
    "mamba2": {"n_layers": 2, "d_model": 64, "vocab": 256},
}
MIX = {"window_size": 8,
       "phases": [{"name": "sparse", "gap": 4.0, "windows": 2},
                  {"name": "dense", "gap": 1.25, "windows": 2}],
       "prompt": {"buckets": [16, 32], "weights": [1, 1]},
       "output": {"dist": "uniform", "min": 1, "max": 6}}


def tiny_config(family: str) -> dict:
    """The repo's configuration file of ``family`` at tiny widths."""
    name = {"qwen2": "qwen2-1.5b", "mamba2": "mamba2-1.3b"}[family]
    cfg = json.loads((REPO / "kbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(copy.deepcopy(TINY[family]))
    rep = {**cfg["program"].get("replace", {}), **PROGRAM[family]}
    if family == "mamba2":
        rep["ssm"] = {"d_state": 16, "head_dim": 16, "expand": 2,
                      "chunk": 32}
    cfg["program"] = {"arch": name, "replace": rep}
    cfg["kermit"]["initial"]["ssm_chunk"] = 32
    return cfg


def make_root(tmp: Path, families=("qwen2",), limit: float = 1.0,
              mix: dict | None = None) -> Path:
    """A benchmark root under ``tmp`` with one tiny cell per family,
    named ``tiny-<family>.mix``, and its limits file."""
    root = Path(tmp) / "bench"
    shutil.copytree(REPO / "kbench", root / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    (root / "kbench" / "traffic" / "mix.json").write_text(
        json.dumps(mix or MIX))
    for fam in families:
        cfg = tiny_config(fam)
        name = f"tiny-{fam}"
        (root / "kbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"kbench/configs/{name}.json",
                                 "reduced": [], "why": "tiny"})
        bench["workloads"].append({"name": f"{name}.mix", "config": name,
                                   "traffic": "mix", "chips": 1,
                                   "why": "tiny"})
        (root / "kbench" / "cells" / f"{name}.mix.json").write_text(
            json.dumps({"unit_s": 0.01, "logit_gap": limit}))
    for p in bench["per_layer"] + bench["end_to_end"]:
        p.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
