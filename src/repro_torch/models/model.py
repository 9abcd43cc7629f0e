"""Unified model interface dispatched on ``cfg.family``.

Port of ``repro/models/model.py``, for the families the port runs so far:
``dense`` (``models/transformer.py``), ``ssm`` (Mamba2) and ``hybrid``
(Zamba2) (``models/ssm_lm.py``).  ``moe`` and ``vlm`` go to the
transformer, which raises for their MoE layers and patch prefix;
``encdec`` raises here.  The loss and training entry points come with the
training slice.

Functions:
  init(gen, cfg)                         -> params (drawn from ``gen``)
  forward(params, cfg, batch, tun)       -> (logits, aux, cache|None)
  prefill(params, cfg, batch, tun)       -> (logits, cache)
  decode(params, cfg, batch, cache, tun) -> (logits, cache), cache in place
  init_cache(cfg, batch, seq)            -> zeroed cache tensors
  input_specs(cfg, shape)                -> {name: (shape, dtype)} for a
                                            prefill or decode batch
  make_batch(gen, cfg, shape)            -> a random batch of those specs
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import ssm_lm as S
from repro_torch.models import transformer as T

_LATER = {
    "encdec": "the encdec family is not ported yet (ROADMAP queue A, item "
              "14b: models/encdec.py)",
}


def _check(cfg: ModelConfig) -> None:
    if cfg.family in _LATER:
        raise NotImplementedError(_LATER[cfg.family])


def init(gen: torch.Generator, cfg: ModelConfig):
    _check(cfg)
    fn = {"ssm": S.init_mamba, "hybrid": S.init_zamba}.get(cfg.family, T.init)
    return fn(gen, cfg)


def forward(params, cfg, batch, tun, *, return_cache=False, cache=None):
    _check(cfg)
    fn = {"ssm": S.forward_mamba, "hybrid": S.forward_zamba}.get(
        cfg.family, T.forward)
    return fn(params, cfg, batch, tun, return_cache=return_cache,
              cache=cache)


def prefill(params, cfg, batch, tun, cache=None):
    """Last-position logits and the cache, written into ``cache`` (in
    place, capacity >= the prompt) when given."""
    logits, _, cache = forward(params, cfg, batch, tun, return_cache=True,
                               cache=cache)
    return logits[:, -1:], cache


def decode(params, cfg, batch, cache, tun):
    _check(cfg)
    fn = {"ssm": S.decode_mamba, "hybrid": S.decode_zamba}.get(
        cfg.family, T.decode_step)
    return fn(params, cfg, batch, cache, tun)


def init_cache(cfg, batch: int, seq: int, dtype=None, device=None):
    """Zeroed cache for ``batch`` sequences of capacity ``seq``.
    ``dtype`` (None: the model dtype) applies to the attention keys and
    values only; SSM states stay fp32 and conv rows in the model dtype."""
    _check(cfg)
    fn = {"ssm": S.cache_mamba, "hybrid": S.cache_zamba}.get(
        cfg.family, T.init_cache)
    return fn(cfg, batch, seq, dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Batch (shape, dtype) pairs for (cfg, shape) of the ported families;
    training batches come with the training slice."""
    _check(cfg)
    B, Sq = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32), "pos": ((), torch.int32)}
    if shape.kind == "train":
        raise NotImplementedError("training batches are not ported yet "
                                  "(ROADMAP queue A, item 15)")
    if cfg.family == "vlm":
        raise NotImplementedError(T._VLM)
    return {"tokens": ((B, Sq), torch.int32)}


def make_batch(gen: torch.Generator, cfg: ModelConfig,
               shape: ShapeSpec) -> dict:
    """Random batch matching ``input_specs``: tokens in [0, vocab) drawn
    from ``gen``, on ``gen``'s device."""
    out = {}
    for k, (shp, dtype) in input_specs(cfg, shape).items():
        if k == "pos":
            out[k] = shape.seq_len - 1
        else:
            out[k] = torch.randint(0, cfg.vocab, shp, generator=gen,
                                   device=gen.device, dtype=dtype)
    return out
