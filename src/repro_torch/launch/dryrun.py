"""Dry run: the cost, collective and memory terms of every (arch × shape)
cell on the production meshes, with nothing allocated and nothing launched.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell's step on 512 forced host devices and reads XLA's analyses.  The port
has no SPMD partitioner and no HLO, so it runs the step itself on fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``, on the CPU, so
each kernel takes its plain version as the reference's host lowering takes
the XLA route) over a ``ShapeMesh`` that only names the axes:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions and attention; elementwise work counts nothing, where XLA
  counts it), divided by the mesh's size;
* bytes accessed from ``ByteCounter``: every op's input and output bytes,
  what eager PyTorch reads and writes (views move nothing).  XLA's fused
  program moves several times fewer, so this term is the eager step's and
  not the reference's (ROADMAP's caveats);
* collective bytes by kind, estimated from the sharding rules
  (``estimate_collectives``), sized with ``roofline.ring_factor``;
* the argument bytes exactly (the state's shards under the rules), and the
  temporary bytes as an estimate from ``MemTracker`` (``estimate_temp``).

Importing this module sets no environment variable (the reference sets
``XLA_FLAGS`` on import) and touches no device.

  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]

Records: experiments/dryrun_torch/<mesh>/<arch>__<shape>[__tag].json

``CardCell`` is the card's counterpart of the reference's full compile: one
real train step of a cell on a device, its temporary memory and seconds.
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import gc
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline import (KINDS, count_params, model_flops,
                                           ring_factor, roofline_terms)
from repro_torch.configs.base import (DEFAULT_TUNABLES, SHAPES, Tunables,
                                      supports)
from repro_torch.configs.registry import ARCHS, get_config, get_shape
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_shape_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding import rules
from repro_torch.train.step import (init_train_state, make_prefill_step,
                                    make_serve_step, make_train_step)

OUT_ROOT = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

def _with_axes(tree, axes_tree) -> list:
    """(tensor, axes) pairs of ``tree`` and its axes tree (the rules'),
    walked together: an int8 moment's (codes, scales) pair has a pair of
    axes tuples."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _with_axes(tree[k], axes_tree[k])]
    if isinstance(tree, tuple):
        return [p for t, a in zip(tree, axes_tree)
                for p in _with_axes(t, a)]
    return [(tree, axes_tree)]


def shard_bytes(tree, axes_tree, mesh) -> float:
    """Bytes one device holds of ``tree`` sharded by ``axes_tree``."""
    return sum(_nbytes(t) / _split(a, mesh)
               for t, a in _with_axes(tree, axes_tree))


def _mesh_axes(axes, mesh) -> list:
    out = []
    for a in rules._resolve(tuple(axes), mesh):
        out.extend(a if isinstance(a, tuple) else [a] if a else [])
    return out


def _split(axes, mesh) -> int:
    """Ways a tensor with logical ``axes`` is split over ``mesh``."""
    return math.prod(mesh.shape[a] for a in _mesh_axes(axes, mesh))


def _nbytes(t) -> int:
    """A tensor's bytes; a step counter or other int holds none."""
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


# ops that read only their input's metadata (dtype, device, shape)
_FILLS = {"new_empty", "new_zeros", "new_ones", "new_full", "empty_like",
          "zeros_like", "ones_like", "full_like", "new_empty_strided"}


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every op's tensor inputs and outputs: what the
    eager step reads and writes.  A view (``_unsafe_view`` too) moves
    nothing, nor does a query that returns no tensor (``prim.device``);
    a fill writes its output and reads nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pytree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        if outs and not func.is_view and name != "_unsafe_view":
            ins = () if name in _FILLS else pytree_leaves((args, kwargs))
            self.bytes += sum(_nbytes(t) for t in (*ins, *outs))
        return out


@dc.dataclass
class Lowered:
    """One cell's step and its arguments, on fake CPU tensors of
    ``mode``: the port's counterpart of a lowered program."""
    mode: FakeTensorMode
    step: object
    args: tuple


def _fake(specs):
    return {k: _fake(v) if isinstance(v, dict) else torch.empty(
        v[0], dtype=v[1]) for k, v in specs.items()}


def _batch(cfg, shape):
    specs = M.input_specs(cfg, shape)
    pos = specs.pop("pos", None)
    batch = _fake(specs)
    if pos is not None:                 # decode writes the last slot
        batch["pos"] = shape.seq_len - 1
    return batch


def _lower(cfg, shape, tun, oc):
    """Build this cell's step and its state, batch and cache on fake CPU
    tensors.  Returns (lowered, n_total, n_active)."""
    mode = FakeTensorMode()
    gen = torch.Generator()
    with mode:
        if shape.kind == "train":
            state = init_train_state(gen, cfg, oc, tun)
            params = state["params"]
            args = (state, _batch(cfg, shape))
            step = make_train_step(cfg, oc, tun, device="cpu")
        else:
            params = M.init(gen, cfg)
            if shape.kind == "prefill":
                args = (params, _batch(cfg, shape))
                step = make_prefill_step(cfg, tun)
            else:
                args = (params, _fake(M.cache_specs(cfg, shape)),
                        _batch(cfg, shape))
                step = make_serve_step(cfg, tun)
    n_total, n_active = count_params(params, cfg)
    return Lowered(mode, step, args), n_total, n_active


def _no_mesh(fn):
    """Run ``fn`` with no mesh set: the fake step is the whole program on
    one device, and a shape-only mesh has no ranks to run collectives."""
    mesh = rules.current_mesh()
    rules.set_mesh(None)
    try:
        return fn()
    finally:
        rules.set_mesh(mesh)


def step_cost(lowered) -> dict:
    """{"flops", "bytes accessed"} of one run of the whole step."""
    def run():
        with lowered.mode, FlopCounterMode(display=False) as fc, \
                ByteCounter() as bc:
            lowered.step(*lowered.args)
        return {"flops": float(fc.get_total_flops()),
                "bytes accessed": float(bc.bytes)}
    return _no_mesh(run)


def step_temp(lowered) -> float:
    """Peak bytes the step allocates on top of its arguments (which
    ``MemTracker`` is not told of): activations, gradients, the new state
    or cache, temporaries."""
    from torch.distributed._tools.mem_tracker import MemTracker

    def run():
        mt = MemTracker()
        with lowered.mode, mt:
            lowered.step(*lowered.args)
        return float(sum(d.get("Total", 0) for d in
                         mt.get_tracker_snapshot("peak").values()))
    return _no_mesh(run)


# ---------------------------------------------------------------------------
# Cost probes: the reference's, since a full-depth fake run of a large cell
# takes half a minute.  Two shallow probes (1 and 2 layer-units) extrapolated
# linearly to the full depth: exact for homogeneous stacks; zamba2's 3
# remainder layers are approximated as half a group (<2%).
# ---------------------------------------------------------------------------


def scale_units(cfg, k: int):
    if cfg.family == "encdec":
        return cfg.replace(n_layers=k, enc_layers=k)
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=k * cfg.hybrid_period)
    if cfg.moe is not None and cfg.moe.first_layer_dense:
        return cfg.replace(n_layers=k + 1)
    return cfg.replace(n_layers=k)


def units_full(cfg) -> float:
    if cfg.family == "encdec":
        return float(cfg.n_layers)
    if cfg.family == "hybrid":
        return cfg.n_layers / cfg.hybrid_period
    if cfg.moe is not None and cfg.moe.first_layer_dense:
        return float(cfg.n_layers - 1)
    return float(cfg.n_layers)


def _extrap(d1, d2, uf: float, scale: float = 1.0) -> dict:
    out = {}
    for key in set(d1) | set(d2):
        a, b = d1.get(key, 0.0), d2.get(key, 0.0)
        marg = max(b - a, 0.0)     # physical per-layer cost is >= 0
        out[key] = (a + (uf - 1.0) * marg) * scale
    return out


def probe_cost(cfg, shape, tun, oc, mesh):
    """(cost_dict, coll_dict) extrapolated to full depth, per device."""
    dp = mesh.size // mesh.shape["model"]
    mb = tun.microbatches if shape.kind == "train" else 1
    probe_b = max(shape.global_batch // mb, min(dp, shape.global_batch))
    mb_scale = shape.global_batch / probe_b
    pshape = dc.replace(shape, global_batch=probe_b)
    ptun = tun.replace(attn_unroll=True, layer_unroll=True, microbatches=1)

    results = []
    for k in (1, 2):
        pcfg = scale_units(cfg, k)
        lowered, _, _ = _lower(pcfg, pshape, ptun, oc)
        cost = {c: v / mesh.size for c, v in step_cost(lowered).items()}
        coll = estimate_collectives(pcfg, pshape, ptun, mesh, lowered.args)
        results.append((cost, coll))
    (c1, l1), (c2, l2) = results
    uf = units_full(cfg)
    return _extrap(c1, c2, uf, mb_scale), _extrap(l1, l2, uf, mb_scale)


def estimate_temp(cfg, shape, tun, oc, mesh) -> float:
    """Temporary bytes of one device's step: ``step_temp`` of the fake
    step at the per-device batch (``global_batch`` over the data shards)
    with the cell's tunables, probed at 1 and 2 layer-units and
    extrapolated to the full depth as the costs are.  The parameters are
    whole in the fake step, so on a mesh that shards them the gradients
    and the new state count unsharded: an upper estimate there."""
    dp = mesh.size // mesh.shape["model"]
    dshape = dc.replace(shape, global_batch=max(shape.global_batch // dp, 1))
    temps = [{"temp": step_temp(_lower(scale_units(cfg, k), dshape, tun,
                                       oc)[0])} for k in (1, 2)]
    return _extrap(*temps, units_full(cfg))["temp"]


# ---------------------------------------------------------------------------
# Collectives, from the sharding rules
# ---------------------------------------------------------------------------


def _add(out, kind, nbytes, g):
    if g > 1:
        out[kind] += nbytes * ring_factor(kind, g)


def _param_collectives(out, kind, tun, mesh, params):
    """zero3's gathers of each parameter sharded over 'data' (forward and
    backward in training, once to serve), the gradient's reduction over
    'data' (a reduce-scatter onto its shard, an all-reduce where it is
    replicated) and over 'pod'."""
    g_data = mesh.shape.get("data", 1)
    g_pod = mesh.shape.get("pod", 1)
    train = kind == "train"
    for t, a in _with_axes(params, rules.param_axes_tree(params, tun.zero3)):
        shard = _nbytes(t) / _split(a, mesh)
        if "data" in _mesh_axes(a, mesh):
            _add(out, "all-gather", (2 if train else 1) * shard * g_data,
                 g_data)
            if train:
                _add(out, "reduce-scatter", shard, g_data)
        elif train:
            _add(out, "all-reduce", shard, g_data)
        if train:
            _add(out, "all-reduce", shard, g_pod)


def _row_parallel_tokens(cfg, shape) -> float:
    """Tokens × outputs of row-parallel projections (attention out, MLP
    or expert combine, SSM out) in one forward pass, per batch row: each
    is a partial sum over 'model'."""
    S = 1 if shape.kind == "decode" else shape.seq_len
    if cfg.family == "encdec":
        half = max(S // 2, 1)
        return half * (2 * cfg.enc_layers + 3 * cfg.n_layers)
    if cfg.family == "ssm":
        return S * cfg.n_layers
    if cfg.family == "hybrid":
        return S * (cfg.n_layers + 2 * (cfg.n_layers // cfg.hybrid_period))
    return S * 2 * cfg.n_layers


def _attn_layers(cfg) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    if cfg.family == "encdec":
        return 2 * cfg.n_layers                    # self and cross
    return cfg.n_layers


def _activation_collectives(out, cfg, shape, tun, mesh, cache):
    """The partial sums over 'model' that tensor parallelism needs: one
    per row-parallel output in the forward (the embedding's lookup too),
    one per column-parallel input in the backward (the tied head's too),
    the forward's again when remat recomputes it; an all-gather and a
    reduce-scatter each under ``seq_parallel``.  A decode cache sharded
    along its sequence combines each attention layer's partial output."""
    tp = mesh.shape.get("model", 1)
    dp = mesh.size // tp
    rows = max(shape.global_batch // dp, 1)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    tok = _row_parallel_tokens(cfg, shape)
    S = 1 if shape.kind == "decode" else shape.seq_len
    if shape.kind == "train":
        n = tok * (2 + (tun.remat != "none")) + 2 * S
    else:
        n = tok + S
    act = rows * n * cfg.d_model * item
    if tun.seq_parallel:
        _add(out, "all-gather", act, tp)
        _add(out, "reduce-scatter", act / tp, tp)
    else:
        _add(out, "all-reduce", act, tp)
    if cache is None:
        return
    keys = []
    rules.tree_map_with_path(lambda names, t: keys.append(
        rules._cache_axes(names[-1], tuple(t.shape)))
        if names[-1] in ("k", "xk", "k0") else None, cache)
    # a (B, S, K, hd) cache's sequence axis
    g_seq = max((_split((a[-3],), mesh) for a in keys), default=1)
    if g_seq > 1:
        partial = rows * cfg.n_heads * (cfg.hd + 2) * 4     # out, max, sum
        _add(out, "all-reduce", _attn_layers(cfg) * partial, g_seq)


def estimate_collectives(cfg, shape, tun, mesh, args) -> dict:
    """Per-device collective bytes by kind of one step on ``mesh``, from
    the step's arguments and the sharding rules; 0 on a mesh of one."""
    out = dict.fromkeys(KINDS, 0.0)
    if mesh.size > 1:
        params = args[0]["params"] if shape.kind == "train" else args[0]
        prev = rules.current_mesh()
        rules.set_mesh(mesh)          # the cache rules read the 'model' size
        try:
            _param_collectives(out, shape.kind, tun, mesh, params)
            _activation_collectives(
                out, cfg, shape, tun, mesh,
                args[1] if shape.kind == "decode" else None)
        finally:
            rules.set_mesh(prev)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _memory(cfg, shape, tun, oc, mesh, lowered) -> dict:
    """The reference's memory_analysis keys for one device.  Arguments:
    the shards of the step's arguments under the rules (exact).  Outputs:
    the new state, or the logits and the cache, as sharded.  Temporary:
    ``estimate_temp``.  There is no generated code to size."""
    args = lowered.args
    if shape.kind == "train":
        state, batch = args
        arg = shard_bytes(state, rules.state_axes_tree(state, tun.zero3),
                          mesh)
        out = arg
        alias = arg if tun.donate else 0.0
    else:
        params, batch = args[0], args[-1]
        arg = shard_bytes(params, rules.param_axes_tree(params, tun.zero3),
                          mesh)
        logits = (shape.global_batch * cfg.vocab_padded
                  * torch.empty((), dtype=getattr(torch, cfg.dtype))
                  .element_size()) / mesh.shape["model"]
        cache = args[1] if shape.kind == "decode" else _fake_cache(cfg,
                                                                   shape)
        cache_b = shard_bytes(cache, rules.cache_axes_tree(cache), mesh)
        out = logits + cache_b
        if shape.kind == "decode":
            arg += cache_b
        alias = cache_b if shape.kind == "decode" and tun.donate else 0.0
    tensors = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
    arg += shard_bytes(tensors, rules.batch_axes_tree(tensors), mesh)
    return {"temp_size_in_bytes": estimate_temp(cfg, shape, tun, oc, mesh),
            "argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "alias_size_in_bytes": alias,
            "generated_code_size_in_bytes": None}


def _fake_cache(cfg, shape):
    with FakeTensorMode():
        return _fake(M.cache_specs(cfg, shape))


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               tun: Tunables = DEFAULT_TUNABLES, oc: OptConfig = OptConfig(),
               verbose: bool = True):
    """Estimate one cell on the shape-only production mesh; returns the
    reference's record.  ``lower_s``: building the full-depth fake state
    and inputs; ``compile_s``: the temporary-memory probes (the memory
    analysis of the reference's compile); ``probe_s``: the cost probes.
    ``cost_raw_scan_once`` and ``generated_code_size_in_bytes`` have no
    counterpart here and are null."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if not supports(cfg, shape):
        raise ValueError(f"unsupported cell {arch}/{shape_name}")
    mesh = make_shape_mesh(multi_pod=multi_pod)
    chips = mesh.size
    prev = rules.current_mesh()
    rules.set_mesh(mesh)
    try:
        t0 = time.time()
        lowered, n_total, n_active = _lower(cfg, shape, tun, oc)
        t_lower = time.time() - t0
        mem = _memory(cfg, shape, tun, oc, mesh, lowered)
        t_compile = time.time() - t0 - t_lower
        if verbose:
            print("memory (per device):", mem)
        cost, coll = probe_cost(cfg, shape, tun, oc, mesh)
        t_probe = time.time() - t0 - t_lower - t_compile
    finally:
        rules.set_mesh(prev)
    if verbose:
        print("cost (extrapolated) flops:", cost.get("flops"),
              "bytes:", cost.get("bytes accessed"))
    mf = model_flops(cfg, shape, n_active)
    rl = roofline_terms(cost, coll, chips=chips, model_flops=mf)

    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "tunables": tun.as_dict(),
        "n_params_total": n_total, "n_params_active": n_active,
        "memory": mem,
        "cost": cost, "cost_raw_scan_once": None,
        "collectives": coll,
        "roofline": rl.as_dict(),
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "probe_s": round(t_probe, 2),
    }


def run_cell(arch, shape_name, *, multi_pod, tun=DEFAULT_TUNABLES, force=False,
             tag="", out_root=OUT_ROOT):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    out_dir = out_root / mesh_name
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out = out_dir / f"{arch}__{shape_name}{suffix}.json"
    if out.exists() and not force:
        print(f"[skip] {mesh_name} {arch} {shape_name} (cached)")
        return json.loads(out.read_text())
    print(f"[dryrun] {mesh_name} {arch} {shape_name} ...", flush=True)
    try:
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod, tun=tun)
    except Exception:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": traceback.format_exc()}
        out.write_text(json.dumps(rec, indent=1))
        print(f"[FAIL] {arch} {shape_name}\n{rec['error']}", flush=True)
        return rec
    out.write_text(json.dumps(rec, indent=1))
    r = rec["roofline"]
    print(f"[ok] {arch} {shape_name}: compute={r['compute_s']:.4f}s "
          f"memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
          f"bottleneck={r['bottleneck']} useful={r['useful_ratio']:.3f} "
          f"(compile {rec['compile_s']}s)", flush=True)
    return rec


def parse_tun(kvs, start: Tunables = DEFAULT_TUNABLES) -> Tunables:
    tun = start
    for kv in kvs or []:
        k, v = kv.split("=", 1)
        cur = getattr(tun, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        tun = tun.replace(**{k: v})
    return tun


# ---------------------------------------------------------------------------
# The card's check: one real step
# ---------------------------------------------------------------------------

# the card's cells are the 16x16 mesh's per data shard
CARD_DATA_SHARDS = 16


def card_shape(shape):
    """The cell's shape on one card: its batch over the 16x16 mesh's data
    shards (``train_4k``: 256 -> 16 rows of 4096)."""
    return dc.replace(shape, global_batch=max(
        shape.global_batch // CARD_DATA_SHARDS, 1))


class CardCell:
    """A train cell run for real on ``device`` (None: CUDA, raising
    without a card) on the (1, 1) host mesh: the reference's full compile
    becomes one step of a candidate.  The state (random weights from seed
    0, zero moments) and the batch are made once; ``run`` steps a
    candidate from them and drops its result.  The host mesh is the
    rules' mesh until ``close``, which puts back the one before it."""

    def __init__(self, cfg, shape, oc: OptConfig = OptConfig(), device=None):
        if shape.kind != "train":
            raise ValueError(f"the card's check runs the train step, not "
                             f"{shape.kind}")
        self.device = resolve_device(device)
        self.cfg, self.shape, self.oc = cfg, shape, oc
        self.mesh = make_host_mesh(self.device)
        self.prev_mesh = rules.current_mesh()
        rules.set_mesh(self.mesh)
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.state = init_train_state(gen, cfg, oc, DEFAULT_TUNABLES)
        self.batch = M.make_batch(gen, cfg, shape)
        self.state_bytes = sum(_nbytes(t) for t in pytree_leaves(
            self.state))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, tun: Tunables) -> dict:
        """Steps of ``tun``: the first measures its temporary bytes (on
        the card ``max_memory_allocated`` above what was allocated before
        it, which holds the state and the batch; on the CPU
        ``MemTracker``'s peak); ``oom`` when the card ran out of memory,
        which is this candidate's measurement.  A candidate that ran runs
        a second step, timed alone, for ``step_s``."""
        step = make_train_step(self.cfg, self.oc, tun, device=self.device)
        rec = {"oom": False, "state_bytes": self.state_bytes}
        cuda = self.device.type == "cuda"
        gc.collect()
        self._sync()
        if cuda:
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        try:
            if cuda:
                step(self.state, self.batch)
                self._sync()
                temp = torch.cuda.max_memory_allocated(self.device) - before
            else:
                from torch.distributed._tools.mem_tracker import MemTracker
                with MemTracker() as mt:
                    step(self.state, self.batch)
                temp = sum(d.get("Total", 0) for d in
                           mt.get_tracker_snapshot("peak").values())
        except torch.cuda.OutOfMemoryError:
            rec["oom"] = True
        rec["first_step_s"] = time.perf_counter() - t0
        if rec["oom"]:
            gc.collect()
            torch.cuda.empty_cache()
            rec["temp_size_in_bytes"] = None
            return rec
        rec["temp_size_in_bytes"] = float(temp)
        rec["temp_source"] = ("torch.cuda.max_memory_allocated" if cuda
                              else "MemTracker")
        t0 = time.perf_counter()
        step(self.state, self.batch)
        self._sync()
        rec["step_s"] = time.perf_counter() - t0
        return rec

    def close(self):
        self.state = self.batch = None
        rules.set_mesh(self.prev_mesh)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--tun", nargs="*", help="tunable overrides k=v")
    args = ap.parse_args(argv)
    tun = parse_tun(args.tun)

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    cells = []
    if args.all:
        from repro_torch.configs.registry import all_cells
        cells = list(all_cells())
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    failures = 0
    for mp in meshes:
        for arch, shape_name in cells:
            rec = run_cell(arch, shape_name, multi_pod=mp, tun=tun,
                           force=args.force, tag=args.tag)
            failures += 1 if "error" in rec else 0
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
