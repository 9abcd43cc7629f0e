"""Serve-step builders.

Port of the serving half of ``repro/train/step.py``:
``prefill_step(params, batch, cache=None) -> (logits, cache)`` and
``serve_step(params, cache, batch) -> (logits, cache)``.  PyTorch runs
eagerly, so a "built" step is a plain closure over (cfg, tunables); the
train step and its optimizer wiring come with the training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, Tunables
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig, tun: Tunables):
    def prefill_step(params, batch, cache=None):
        return M.prefill(params, cfg, batch, tun, cache=cache)
    return prefill_step


def make_serve_step(cfg: ModelConfig, tun: Tunables):
    def serve_step(params, cache, batch):
        return M.decode(params, cfg, batch, cache, tun)
    return serve_step
