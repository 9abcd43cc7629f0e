"""Roofline terms of one step per (arch × shape × mesh).

Port of ``repro/analysis/roofline.py``.  Three terms, in seconds:
  compute    = per-device FLOPs / peak FLOP/s
  memory     = per-device bytes accessed / memory bandwidth
  collective = per-device collective payload bytes / one link's bandwidth
               (conservative; ``ring_factor`` approximates ring algorithms)

The chip's constants are a choice (``Chip``).  ``H100``, the default, is
the H100 SXM's data sheet: 989e12 FLOP/s dense bf16 and 3.35e12 B/s of
HBM3.  Its link is one 400 Gb/s NDR InfiniBand port, 50e9 B/s: a 16-wide
mesh axis spans more than one 8-GPU node, and the DGX H100 gives each GPU
one ConnectX-7 port.  NVLink's 450 GB/s a direction holds only inside a
node.  ``V5E`` keeps the reference's TPU v5e constants, so that the parity
tests can feed both packages the same inputs; nothing in the port reports
a number at them.

``collective_bytes`` is the reference's HLO parser, kept for parity: the
port lowers no HLO, and its dry run estimates collectives from the
sharding rules (``launch/dryrun.py``) with the same ``ring_factor``.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from typing import NamedTuple


class Chip(NamedTuple):
    name: str
    peak_flops: float      # FLOP/s per chip
    hbm_bw: float          # bytes/s per chip
    link_bw: float         # bytes/s per link


H100 = Chip("H100 SXM", 989e12, 3.35e12, 50e9)
V5E = Chip("TPU v5e", 197e12, 819e9, 50e9)

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0, "tuple": 0,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^\s]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(", re.M)

_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def ring_factor(kind: str, g: int) -> float:
    """Bytes one device sends per byte of the collective's per-device
    result, over a group of ``g`` on a ring: an all-reduce sends
    2(g−1)/g of its buffer, a reduce-scatter (g−1) shards of its result,
    an all-gather or all-to-all (g−1)/g of its result, a permute all of
    it."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g
    if kind == "collective-permute":
        return 1.0
    raise ValueError(f"unknown collective {kind!r}")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _tuple_bytes(spec: str) -> int:
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", spec):
        total += _shape_bytes(m.group(1), m.group(2))
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-device payload bytes by collective kind."""
    out = dict.fromkeys(KINDS, 0.0)
    for m in _COLL_RE.finditer(hlo_text):
        tup, dtype, dims, op = m.groups()
        size = _tuple_bytes(tup) if tup else _shape_bytes(dtype, dims)
        # replica group size for the ring factors — same line only
        eol = hlo_text.find("\n", m.end())
        tail = hlo_text[m.end():eol if eol != -1 else m.end() + 400]
        g = 0
        gm = _GROUPS_RE.search(tail)
        if gm:
            g = gm.group(1).count(",") + 1
        else:
            gm = _GROUPS_IOTA_RE.search(tail)
            if gm:
                g = int(gm.group(2))
        out[op] += size * ring_factor(op, max(g, 2))
    out["total"] = sum(out.values())
    return out


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float               # MODEL_FLOPS / (FLOPs * chips)

    def as_dict(self):
        return asdict(self)


def roofline_terms(cost: dict, coll: dict, *, chips: int,
                   model_flops: float, chip: Chip = H100) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total", 0.0))
    terms = {"compute": flops / chip.peak_flops,
             "memory": byts / chip.hbm_bw,
             "collective": cb / chip.link_bw}
    bn = max(terms, key=terms.get)
    return Roofline(
        flops_per_device=flops, bytes_per_device=byts,
        coll_bytes_per_device=cb,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=bn,
        model_flops=model_flops,
        useful_ratio=model_flops / max(flops * chips, 1.0),
    )


def count_params(tree, cfg) -> tuple[float, float]:
    """(N_total, N_active) of a parameter tree (nested dicts of tensors,
    real, fake or on the meta device); MoE expert tensors scale by
    top_k / num_experts for the active count."""
    from repro_torch.sharding.rules import tree_map_with_path

    counts = []

    def visit(names, leaf):
        n = 1
        for d in leaf.shape:
            n *= d
        routed = cfg.moe is not None and "moe" in names and \
            names[-1] in ("wi", "wg", "wo") and "shared" not in names \
            and "dense" not in names
        counts.append((n, n * cfg.moe.top_k / cfg.moe.num_experts
                       if routed else n))
    tree_map_with_path(visit, tree)
    total = active = 0.0
    for n, a in counts:
        total += n
        active += a
    return total, active


def model_flops(cfg, shape, n_active: float) -> float:
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    per_tok = 6.0 if shape.kind == "train" else 2.0
    return per_tok * n_active * tokens
