"""Architecture registry: --arch <id> -> ModelConfig."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES, supports, reduced

ARCHS = [
    "internlm2-1.8b",
    "qwen2-1.5b",
    "gemma2-9b",
    "qwen3-14b",
    "paligemma-3b",
    "seamless-m4t-large-v2",
    "zamba2-7b",
    "deepseek-moe-16b",
    "arctic-480b",
    "mamba2-1.3b",
]

_MOD = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(_MOD[name]).CONFIG


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def all_cells():
    """Every supported (arch, shape) pair — the dry-run/roofline matrix."""
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if supports(cfg, s):
                yield a, s.name


__all__ = ["ARCHS", "get_config", "get_shape", "all_cells", "supports", "reduced"]
