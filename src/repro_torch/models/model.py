"""Unified model interface dispatched on ``cfg.family``.

Port of ``repro/models/model.py``, for the families the port runs so far:
``dense`` (``models/transformer.py``), ``ssm`` (Mamba2) and ``hybrid``
(Zamba2) (``models/ssm_lm.py``).  ``moe`` and ``vlm`` go to the
transformer, which raises for their MoE layers and patch prefix;
``encdec`` raises here.

Functions:
  init(gen, cfg)                         -> params (drawn from ``gen``)
  forward(params, cfg, batch, tun)       -> (logits, aux, cache|None)
  loss_fn(params, cfg, batch, tun)       -> (loss, {"ce", "aux"})
  prefill(params, cfg, batch, tun)       -> (logits, cache)
  decode(params, cfg, batch, cache, tun) -> (logits, cache), cache in place
  init_cache(cfg, batch, seq)            -> zeroed cache tensors
  input_specs(cfg, shape)                -> {name: (shape, dtype)} for a
                                            train, prefill or decode batch
  cache_specs(cfg, shape)                -> {name: (shape, dtype)} of the
                                            cache, nothing allocated
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


def cross_entropy(logits, targets, mask, vocab: int | None = None):
    """Mean token cross-entropy over ``mask`` in fp32; logits past
    ``vocab`` (the padded rows) are masked to -1e30 first."""
    logits = logits.to(torch.float32)
    if vocab is not None and logits.shape[-1] > vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
        logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def loss_fn(params, cfg, batch, tun):
    """(loss, {"ce", "aux"}) of a train batch: cross-entropy + the
    forward's auxiliary loss."""
    logits, aux, _ = forward(params, cfg, batch, tun)
    ce = cross_entropy(logits, batch["targets"], batch["mask"], cfg.vocab)
    return ce + aux, {"ce": ce, "aux": aux}


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
    """Batch (shape, dtype) pairs for (cfg, shape) of the ported families:
    a train batch adds ``targets`` (int32) and ``mask`` (fp32) to the
    tokens."""
    _check(cfg)
    B, Sq = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32), "pos": ((), torch.int32)}
    if cfg.family == "vlm":
        raise NotImplementedError(T._VLM)
    d = {"tokens": ((B, Sq), torch.int32)}
    if shape.kind == "train":
        d["targets"] = ((B, Sq), torch.int32)
        d["mask"] = ((B, Sq), torch.float32)
    return d


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """(shape, dtype) of each cache tensor for (cfg, shape), as nested
    dicts like the cache; allocates nothing (a cache on the meta
    device)."""
    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       device="meta")

    def spec(t):
        if isinstance(t, dict):
            return {k: spec(v) for k, v in t.items()}
        return tuple(t.shape), t.dtype
    return spec(cache)


def make_batch(gen: torch.Generator, cfg: ModelConfig,
               shape: ShapeSpec) -> dict:
    """Random batch matching ``input_specs``: tokens and targets in
    [0, vocab) drawn from ``gen``, a mask of ones, on ``gen``'s device."""
    out = {}
    for k, (shp, dtype) in input_specs(cfg, shape).items():
        if k == "pos":
            out[k] = shape.seq_len - 1
        elif k == "mask":
            out[k] = torch.ones(shp, dtype=dtype, device=gen.device)
        else:
            out[k] = torch.randint(0, cfg.vocab, shp, generator=gen,
                                   device=gen.device, dtype=dtype)
    return out
