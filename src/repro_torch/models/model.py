"""Unified model interface dispatched on ``cfg.family``.

Port of ``repro/models/model.py``, for every family of the reference:
``dense``, ``moe`` and ``vlm`` (``models/transformer.py``), ``ssm``
(Mamba2) and ``hybrid`` (Zamba2) (``models/ssm_lm.py``) and ``encdec``
(``models/encdec.py``), each a row of ``FAMILIES``.

Functions:
  init(gen, cfg)                         -> params (drawn from ``gen``)
  forward(params, cfg, batch, tun)       -> (logits, aux, cache|None)
  loss_fn(params, cfg, batch, tun)       -> (loss, {"ce", "aux"})
  prefill(params, cfg, batch, tun)       -> (logits, cache)
  decode(params, cfg, batch, cache, tun) -> (logits, cache), cache in place
  init_cache(cfg, batch, seq)            -> zeroed cache tensors
  serve_cache(cfg, batch, prompt_len, capacity) -> a serve call's cache
  input_specs(cfg, shape)                -> {name: (shape, dtype)} for a
                                            train, prefill or decode batch
  cache_specs(cfg, shape)                -> {name: (shape, dtype)} of the
                                            cache, nothing allocated
  make_batch(gen, cfg, shape)            -> a random batch of those specs
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.dispatch import takes_kernels
from repro_torch.models import encdec as ED
from repro_torch.models import ssm_lm as S
from repro_torch.models import transformer as T


class Family(NamedTuple):
    """One family's functions.  ``graph_reads(tun)``: what its decode
    step reads of the Tunables, their whole part in the key of the CUDA
    graph the serving engine replays the step from; None: the engine
    runs the step eagerly."""
    init: Callable
    forward: Callable
    decode: Callable
    cache: Callable
    graph_reads: Optional[Callable]


_TRANSFORMER = (T.init, T.forward, T.decode_step, T.init_cache)
FAMILIES = {
    # one query row is one chunk under any attn_q_chunk: nothing read
    "dense": Family(*_TRANSFORMER, lambda tun: ()),
    "moe": Family(*_TRANSFORMER, None),
    "vlm": Family(*_TRANSFORMER, None),
    # the fused step kernel or the plain step
    "ssm": Family(S.init_mamba, S.forward_mamba, S.decode_mamba,
                  S.cache_mamba, lambda tun: (takes_kernels(tun.attn_impl),)),
    "hybrid": Family(S.init_zamba, S.forward_zamba, S.decode_zamba,
                     S.cache_zamba, None),
    "encdec": Family(ED.init, ED.forward, ED.decode_step, ED.init_cache,
                     None),
}


def init(gen: torch.Generator, cfg: ModelConfig):
    return FAMILIES[cfg.family].init(gen, cfg)


def forward(params, cfg, batch, tun, *, return_cache=False, cache=None):
    return FAMILIES[cfg.family].forward(params, cfg, batch, tun,
                                        return_cache=return_cache,
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
    return FAMILIES[cfg.family].decode(params, cfg, batch, cache, tun)


def init_cache(cfg, batch: int, seq: int, dtype=None, device=None,
               self_len: int | None = None):
    """Zeroed cache for ``batch`` sequences of capacity ``seq``.
    ``dtype`` (None: the model dtype) applies to the self-attention keys
    and values only; SSM states stay fp32, conv rows and the encdec
    family's cross-attention keys and values in the model dtype.  For
    encdec, ``seq`` counts frames and tokens, half each (the reference's
    layout), and ``self_len`` sets the self-attention positions (default
    seq // 2); the other families take no ``self_len``."""
    if self_len is not None and cfg.family != "encdec":
        raise ValueError(f"self_len is for the encdec family, not "
                         f"{cfg.family}")
    kw = {} if self_len is None else {"self_len": self_len}
    return FAMILIES[cfg.family].cache(cfg, batch, seq, dtype=dtype,
                                      device=device, **kw)


def serve_cache(cfg, batch: int, prompt_len: int, capacity: int,
                dtype=None, device=None):
    """The zeroed cache of one serve call: the reference's prefill cache
    padded by ``capacity - prompt_len``.  The encdec decoder holds
    ``prompt_len // 2`` tokens, so its self-attention gets that many
    positions plus the padding; decode clamps its writes past them to the
    last (ROADMAP C20)."""
    if cfg.family == "encdec":
        return init_cache(cfg, batch, prompt_len, dtype=dtype, device=device,
                          self_len=prompt_len // 2 + capacity - prompt_len)
    return init_cache(cfg, batch, capacity, dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Batch (shape, dtype) pairs for (cfg, shape): tokens, and the vlm
    family's patch embeddings (the text is ``seq_len - num_patches``
    long; a ValueError if that is not positive) or the encdec family's
    frame embeddings (half of ``seq_len`` each); a train batch adds
    ``targets`` (int32) and ``mask`` (fp32)."""
    B, Sq = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, getattr(torch, cfg.dtype)
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32), "pos": ((), i32)}
    if cfg.family == "vlm":
        npt = cfg.num_patches
        if Sq <= npt:
            raise ValueError(f"{cfg.name}'s prompt of {Sq} positions must "
                             f"exceed its {npt} patches")
        d = {"tokens": ((B, Sq - npt), i32),
             "patches": ((B, npt, cfg.d_model), dt)}
    elif cfg.family == "encdec":
        Sq = Sq // 2
        d = {"frames": ((B, Sq, cfg.d_model), dt), "tokens": ((B, Sq), i32)}
    else:
        d = {"tokens": ((B, Sq), i32)}
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
    [0, vocab) and standard-normal patches or frames (cast to the model
    dtype) drawn from ``gen``, a mask of ones, on ``gen``'s device."""
    out = {}
    for k, (shp, dtype) in input_specs(cfg, shape).items():
        if k == "pos":
            out[k] = shape.seq_len - 1
        elif k == "mask":
            out[k] = torch.ones(shp, dtype=dtype, device=gen.device)
        elif dtype.is_floating_point:
            out[k] = torch.randn(shp, generator=gen,
                                 device=gen.device).to(dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab, shp, generator=gen,
                                   device=gen.device, dtype=dtype)
    return out

