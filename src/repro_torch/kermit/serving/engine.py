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
(``models/model.serve_cache``).

Serving-specific knobs (``configs/base.Tunables``):

  serve_batch    decode batch size — owned by the executor's chunking, the
                 engine just serves whatever batch it is handed
  prefill_chunk  attention q-chunk override for the prefill (0 = inherit
                 ``attn_q_chunk``)
  cache_len      KV-cache capacity rounding multiple (0 = exact fit).
                 Decode masks attention by true position (``kv_len=pos+1``),
                 so over-allocated capacity is numerically free
  cache_dtype    KV storage precision ("auto" = model dtype)

The decode graph: on the card, a call that runs at least two decode
steps of a family whose row in ``models/model.FAMILIES`` has
``graph_reads`` replays its step from a CUDA graph, one launch a step
where the eager step issues hundreds to thousands (a one-step call never
replays what it would capture, so it runs eagerly, as every call on the
CPU and of the other families does).  The graph is captured on the
first such call of its key (``decode_graph_key``: the batch, the cache's
shapes and dtype, and the family's ``graph_reads`` of the Tunables)
and kept, with its static buffers, for the engine's parameters: the
serve cache, zeroed and filled by the prefill at the start of each call;
the step's tokens and position, which the graph advances itself (the
greedy tokens are taken inside it); the logits.  At most
``_DECODE_GRAPHS_MAX`` keys are kept, least recently used first out; all
share one memory pool and replay one after another on one stream.  No
graph is captured while a profiler records: such a call without a graph
runs eagerly.  A replayed decode records no detail spans: under a
profiler each replay's launch takes milliseconds on the host, more or
less from step to step, so a span around it would not say when the
step ran on the device.  ``stats["decode_graph_captures"/
"decode_graph_steps"]`` count the captures and the replayed steps; the
``engine.decode`` span's ``graph`` says whether its steps were
replayed, and ``engine.capture`` times each capture.

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
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import trace as T
from repro_torch.train.step import make_prefill_step, make_serve_step

# the most decode graphs, each with its static cache, an engine keeps
_DECODE_GRAPHS_MAX = 16


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


class _DecodeGraph:
    """One greedy decode step captured as a CUDA graph over static
    buffers: ``cache``, the step's input ``tokens`` (B, 1) int32 and
    position ``pos`` (0-dim int64).  A replay runs the step at ``pos``,
    writes its greedy tokens into ``tokens`` and advances ``pos``, so
    replays follow one another with no input from the host."""

    def __init__(self, params, decode, cache, batch: int, dev, pool):
        self.cache = cache
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)

        def step():
            logits, _ = decode(params, cache,
                               {"tokens": self.tokens, "pos": self.pos})
            self.tokens.copy_(torch.argmax(logits[:, -1], -1)[
                :, None].to(torch.int32))
            self.pos.add_(1)
            return logits
        # one eager step on a side stream first, as capture asks (its
        # writes land in the cache, which each call zeroes before its
        # prefill)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.logits = step()


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
        self._graphs: OrderedDict = OrderedDict()  # graph key -> graph
        self._graph_pool = None
        self._graph_params: list = []  # the parameters the graphs read
        self.stats = {"prefill_builds": 0, "decode_builds": 0,
                      "serve_calls": 0, "decode_steps": 0,
                      "decode_graph_captures": 0, "decode_graph_steps": 0}

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
        key = (prompt_len, batch)
        b = self._batches.get(key)
        if b is None:
            b = M.make_batch(self._generator(), self.cfg,
                             ShapeSpec("pf", prompt_len, batch, "prefill"))
            self._batches[key] = b
        return b

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- decode graphs ------------------------------------------------------

    def _graphed(self, steps: int) -> bool:
        """Whether a call of ``steps`` decode steps replays a graph: on
        the card, for a family with ``graph_reads``, at two steps or
        more."""
        return (steps >= 2 and self.device.type == "cuda"
                and M.FAMILIES[self.cfg.family].graph_reads is not None)

    def decode_graph_key(self, tun: Tunables, batch: int,
                         capacity: int) -> tuple:
        """What a captured decode step depends on besides the weights:
        the shapes and dtypes of the serve cache it updates (they hold the
        batch, and for a KV cache the capacity; an SSM state has none) and
        its family's ``graph_reads`` of the Tunables, and nothing else."""
        cache = M.init_cache(self.cfg, batch, capacity,
                             dtype=_cache_dtype(tun), device="meta")
        return (tuple((tuple(t.shape), t.dtype) for t in tree_leaves(cache)),
                M.FAMILIES[self.cfg.family].graph_reads(tun))

    def _decode_graph(self, tun: Tunables, batch: int, prompt_len: int,
                      capacity: int, decode) -> Optional[_DecodeGraph]:
        """The graph of this call's key, captured now if the key has none
        (but not while a profiler records: then None).  Graphs read the
        parameters they were captured with, so new ones drop them all."""
        leaves = tree_leaves(self.params)
        if len(leaves) != len(self._graph_params) or any(
                a is not b for a, b in zip(leaves, self._graph_params)):
            self._graphs.clear()
            self._graph_params = leaves
        key = self.decode_graph_key(tun, batch, capacity)
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            return graph
        if T.profiling():
            return None
        with T.span("engine.capture", batch=batch, capacity=capacity):
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            cache = M.serve_cache(self.cfg, batch, prompt_len, capacity,
                                  dtype=_cache_dtype(tun), device=self.device)
            graph = _DecodeGraph(self.params, decode, cache, batch,
                                 self.device, self._graph_pool)
        self._graphs[key] = graph
        self.stats["decode_graph_captures"] += 1
        while len(self._graphs) > _DECODE_GRAPHS_MAX:
            self._graphs.popitem(last=False)
        return graph

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
            graph = (self._decode_graph(tun, batch, prompt_len, capacity,
                                        decode)
                     if self._graphed(steps) else None)

            with T.span("engine.prefill") as pf:
                if graph is None:
                    cache = M.serve_cache(self.cfg, batch, prompt_len,
                                          capacity, dtype=_cache_dtype(tun),
                                          device=self.device)
                else:
                    cache = graph.cache
                    for t in tree_leaves(cache):
                        t.zero_()
                logits, cache = prefill(self.params, b, cache)
                self._sync()

            tokens = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            with T.span("engine.decode", steps=steps,
                        graph=graph is not None) as dc, \
                    T.detailed(graph is None and T.profiling()):
                if graph is None:
                    out = [tokens]
                    for i in range(steps):
                        with T.detail("engine.step"):
                            step_batch = {"tokens": tokens,
                                          "pos": prompt_len + i}
                            logits, cache = decode(self.params, cache,
                                                   step_batch)
                            with T.detail("engine.sample"):
                                tokens = torch.argmax(logits[:, -1], -1)[
                                    :, None].to(torch.int32)
                                out.append(tokens)
                    self._sync()
                else:
                    out = torch.empty((batch, 1 + steps), dtype=torch.int32,
                                      device=self.device)
                    out[:, :1] = tokens
                    graph.tokens.copy_(tokens)
                    graph.pos.fill_(prompt_len)
                    for i in range(steps):
                        graph.graph.replay()
                        out[:, i + 1:i + 2] = graph.tokens
                    self._sync()
                    self.stats["decode_graph_steps"] += steps

            self.stats["serve_calls"] += 1
            self.stats["decode_steps"] += steps
            if graph is None:
                out = torch.cat(out, 1)
            generated = out.cpu().numpy()
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


def _cache_dtype(tun: Tunables):
    """The KV cache's dtype under ``tun`` (None: the model's)."""
    return None if tun.cache_dtype == "auto" else getattr(torch,
                                                          tun.cache_dtype)


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
