"""ServeEngine — the real inference stack as a reconfigurable resource.

Port of ``repro/kermit/serving/engine.py``.  The engine holds the model
once and caches its steps per configuration:

  params           drawn once per (cfg, seed) from a ``torch.Generator``
                   on the engine's device (the reference's ``jax.random``
                   draws differ; tests hand both engines the same weights)
  prefill/decode   plain closures cached per effective Tunables — PyTorch
                   runs eagerly, so nothing is compiled, but
                   ``stats["prefill_builds"/"decode_builds"]`` still count
                   first uses, as the reference counts its jit builds
  apply/serve      ``apply(tunables)`` stages a configuration;
                   ``serve(...)`` runs batched prefill + greedy decode under
                   it and reports wall-clock timings (ending in
                   ``torch.cuda.synchronize()`` on the card, where the
                   reference blocks until ready) + per-request completion
                   times; the timings are the durations of its
                   ``engine.prefill``/``engine.decode`` spans
                   (``runtime/trace.py``), and while a profiler records,
                   each decode step records its detail spans

``serve`` allocates the KV cache once, at ``capacity_for(...)`` positions
in ``cache_dtype``; prefill writes its keys and values into it and decode
updates it in place, so there is no pad-and-cast copy between them.  The
cache has the shapes the reference's padded prefill cache has
(``_serve_cache``): for the vlm family the prompt counts the patches;
for encdec the decoder holds ``prompt_len // 2`` tokens, so its
self-attention keys and values get ``prompt_len // 2 + capacity -
prompt_len`` positions, the cross-attention ones exactly the encoder
memory's, and decode writes past the last position land on it, as the
reference's clamped ``dynamic_update_slice`` writes them (ROADMAP C20).

Serving-specific knobs (``configs/base.Tunables``):

  serve_batch    decode batch size — owned by the executor's chunking, the
                 engine just serves whatever batch it is handed
  prefill_chunk  attention q-chunk override for the prefill (0 = inherit
                 ``attn_q_chunk``)
  cache_len      KV-cache capacity rounding multiple (0 = exact fit).
                 Decode masks attention by true position (``kv_len=pos+1``),
                 so over-allocated capacity is numerically free
  cache_dtype    KV storage precision ("auto" = model dtype)

``device=None`` means CUDA, as for every entry point of the port.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (DEFAULT_TUNABLES, ModelConfig,
                                      ShapeSpec, Tunables, reduced)
from repro_torch.configs.registry import get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as M
from repro_torch.runtime import trace as T
from repro_torch.train.step import make_prefill_step, make_serve_step


def tiny_config(arch: str, **kw) -> ModelConfig:
    """CPU-CI-sized family-faithful config (2 layers, d_model 64) — the
    model the serving scenarios/benchmarks manage."""
    cfg = reduced(get_config(arch))
    small = dict(n_layers=2, d_model=64, n_heads=2,
                 n_kv_heads=1 if cfg.n_kv_heads == 1 else 2,
                 d_ff=128, vocab=256, head_dim=32, dtype="float32")
    if cfg.hybrid_period:
        small["hybrid_period"] = 2
        small["n_layers"] = 5
    if cfg.enc_layers:
        small["enc_layers"] = 2
    if cfg.num_patches:
        small["num_patches"] = 8
    small.update(kw)
    return cfg.replace(**small)


@dataclass
class ServeReport:
    """One engine call: timings plus per-request completion estimates."""
    batch: int
    prompt_len: int
    gen: np.ndarray               # (B,) decoded tokens per request
    capacity: int                 # KV capacity (prompt + padding)
    prefill_s: float
    decode_s: float
    steps: int                    # decode steps run (= max(gen))
    generated: np.ndarray         # (B, 1 + steps) greedy tokens
    completion_s: np.ndarray = field(default=None)  # (B,) service latency

    def __post_init__(self):
        if self.completion_s is None:
            # decode cost attributed uniformly per step: a request that
            # needs g tokens completes after g steps of the shared batch
            step_s = self.decode_s / max(self.steps, 1)
            self.completion_s = self.prefill_s + step_s * np.asarray(
                self.gen, np.float64)

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    @property
    def tokens(self) -> int:
        return int(np.sum(self.gen)) + self.batch   # + first prefill token


class ServeEngine:
    """Holds params + cached prefill/decode steps for one model config.

    ``apply(tunables)`` stages the active configuration; ``serve`` accepts an
    explicit ``tunables=`` override so batched candidate probes never move
    the applied state (the Execute-protocol probe contract).
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 initial: Tunables = DEFAULT_TUNABLES, device=None):
        self.cfg = cfg
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.params = M.init(self._generator(), cfg)
        self.tunables = initial
        self._prefill: dict = {}     # effective Tunables -> prefill step
        self._decode: dict = {}      # Tunables -> decode step
        self._batches: dict = {}     # (prompt_len, batch) -> token batch
        self.stats = {"prefill_builds": 0, "decode_builds": 0,
                      "serve_calls": 0, "decode_steps": 0}

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed)

    # -- configuration ------------------------------------------------------

    def apply(self, tunables: Tunables) -> None:
        """Stage ``tunables`` as the engine's active configuration."""
        self.tunables = tunables

    # -- step caches --------------------------------------------------------

    def _prefill_effective(self, tun: Tunables) -> Tunables:
        if tun.prefill_chunk > 0:
            return tun.replace(attn_q_chunk=tun.prefill_chunk)
        return tun

    def prefill_step(self, tun: Tunables):
        eff = self._prefill_effective(tun)
        fn = self._prefill.get(eff)
        if fn is None:
            fn = make_prefill_step(self.cfg, eff)
            self._prefill[eff] = fn
            self.stats["prefill_builds"] += 1
        return fn

    def decode_step(self, tun: Tunables):
        fn = self._decode.get(tun)
        if fn is None:
            fn = make_serve_step(self.cfg, tun)
            self._decode[tun] = fn
            self.stats["decode_builds"] += 1
        return fn

    def _token_batch(self, prompt_len: int, batch: int):
        npt = self.cfg.num_patches if self.cfg.family == "vlm" else 0
        if prompt_len <= npt:
            raise ValueError(f"{self.cfg.name}'s prompt of {prompt_len} "
                             f"positions must exceed its {npt} patches")
        key = (prompt_len, batch)
        b = self._batches.get(key)
        if b is None:
            b = M.make_batch(self._generator(), self.cfg,
                             ShapeSpec("pf", prompt_len, batch, "prefill"))
            self._batches[key] = b
        return b

    def _serve_cache(self, batch: int, prompt_len: int, capacity: int,
                     dtype):
        """The zeroed cache of one serve call, shaped as the reference's
        prefill cache once padded by ``capacity - prompt_len`` (names k,
        v, k0, v0; only they take ``cache_dtype``)."""
        if self.cfg.family == "encdec":
            return M.init_cache(self.cfg, batch, prompt_len, dtype=dtype,
                                device=self.device,
                                self_len=prompt_len // 2 + capacity
                                - prompt_len)
        return M.init_cache(self.cfg, batch, capacity, dtype=dtype,
                            device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the serve path -----------------------------------------------------

    def capacity_for(self, prompt_len: int, max_gen: int,
                     tun: Optional[Tunables] = None) -> int:
        tun = tun or self.tunables
        cap = prompt_len + max_gen
        if tun.cache_len > 0:
            cap = -(-cap // tun.cache_len) * tun.cache_len
        return cap

    def serve(self, *, batch: int, prompt_len: int,
              gen: int | Sequence[int],
              tunables: Optional[Tunables] = None,
              purpose: str = "serve") -> ServeReport:
        """Batched prefill + greedy decode.  ``gen`` is either one length
        for the whole batch or a per-request vector; the batch runs
        ``max(gen)`` steps and each request's completion time is attributed
        at its own length.  ``purpose`` labels the call's span (the
        executor's ``warm`` and ``calibrate`` serves)."""
        tun = tunables if tunables is not None else self.tunables
        gen_vec = np.full(batch, int(gen), np.int64) \
            if np.isscalar(gen) else np.asarray(gen, np.int64)
        if gen_vec.shape != (batch,):
            raise ValueError(f"gen vector shape {gen_vec.shape} != ({batch},)")
        steps = int(gen_vec.max())
        capacity = self.capacity_for(prompt_len, steps, tun)

        with T.span("engine.serve", batch=batch, prompt=prompt_len,
                    steps=steps, capacity=capacity, purpose=purpose) as call:
            call.anchor()
            prefill = self.prefill_step(tun)
            decode = self.decode_step(tun)
            b = self._token_batch(prompt_len, batch)
            cache_dt = None if tun.cache_dtype == "auto" \
                else getattr(torch, tun.cache_dtype)

            with T.span("engine.prefill") as pf:
                cache = self._serve_cache(batch, prompt_len, capacity,
                                          cache_dt)
                logits, cache = prefill(self.params, b, cache)
                self._sync()

            tokens = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            out = [tokens]
            with T.span("engine.decode", steps=steps) as dc, \
                    T.detailed(T.profiling()):
                for i in range(steps):
                    with T.detail("engine.step"):
                        step_batch = {"tokens": tokens, "pos": prompt_len + i}
                        logits, cache = decode(self.params, cache, step_batch)
                        with T.detail("engine.sample"):
                            tokens = torch.argmax(logits[:, -1], -1)[
                                :, None].to(torch.int32)
                            out.append(tokens)
                self._sync()

            self.stats["serve_calls"] += 1
            self.stats["decode_steps"] += steps
            generated = torch.cat(out, 1).cpu().numpy()
        return ServeReport(
            batch=batch, prompt_len=prompt_len, gen=gen_vec,
            capacity=capacity, prefill_s=pf.seconds, decode_s=dc.seconds,
            steps=steps, generated=generated)

    def serve_legacy(self, batch: int, prompt_len: int, gen: int,
                     tun: Tunables) -> dict:
        """The ``launch/serve.py`` result dict, unchanged (CLI contract)."""
        rep = self.serve(batch=batch, prompt_len=prompt_len, gen=gen,
                         tunables=tun)
        return {
            "prefill_s": rep.prefill_s,
            "decode_s": rep.decode_s,
            "decode_tok_per_s": batch * gen / rep.decode_s,
            "generated": rep.generated.tolist(),
        }


# -- process-wide engine cache (the launcher's entry point) ------------------

_ENGINES: "OrderedDict" = OrderedDict()
_ENGINE_CACHE_MAX = 8


def get_engine(cfg: ModelConfig, seed: int = 0, *,
               max_engines: int | None = None, device=None) -> ServeEngine:
    """The shared engine for (cfg, seed, device): params are initialized
    and steps built once per process, however many ``serve_batch`` calls
    run.

    The cache is LRU-bounded: a hit refreshes the entry's recency and an
    insert past the bound evicts the least-recently-used engine (params +
    cached steps become collectable).  ``max_engines`` overrides the
    process-wide bound for this call — a fleet serving many model configs
    can widen it, a memory-tight host can pin it to 1."""
    bound = _ENGINE_CACHE_MAX if max_engines is None else int(max_engines)
    if bound < 1:
        raise ValueError(f"max_engines must be >= 1, got {max_engines}")
    dev = resolve_device(device)
    key = (cfg, int(seed), str(dev))
    eng = _ENGINES.get(key)
    if eng is not None:
        _ENGINES.move_to_end(key)
    else:
        eng = ServeEngine(cfg, seed=seed, device=dev)
        _ENGINES[key] = eng
    while len(_ENGINES) > bound:
        _ENGINES.popitem(last=False)
    return eng
