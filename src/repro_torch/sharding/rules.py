"""Sharding rules: logical axes -> partition specs and DTensor placements.

Port of ``repro/sharding/rules.py``.  Logical axes:
  'batch' — data-parallel dim of activations/inputs; maps to ('pod','data') on
            the multi-pod mesh and 'data' on the single-pod mesh.
  'data'  — FSDP/ZeRO param+optimizer shard axis (within-pod only: params are
            replicated across pods, gradients all-reduce over 'pod').
  'model' — tensor/expert/sequence-parallel axis.

Param specs are derived from leaf names and shapes (see models/*), with any
extra leading stacking axes (layers, zamba2 groups) replicated.  The trees
are the port's: nested dicts, an int8 moment one ``(codes, scales)`` tuple
leaf, whose positions count as path names ``"0"`` and ``"1"`` as jax's key
paths count them; an axes tree has the tree's structure with an axes tuple
in place of each tensor (a pair of them for an int8 moment).  A partition
spec is a plain tuple, one entry per tensor dim: a mesh axis name, a tuple
of names (one dim sharded over several mesh axes), or None.

``set_mesh`` takes a ``repro_torch.launch.mesh.Mesh``; the rules read only
its ``axis_names`` and ``shape``.  ``named`` gives the DTensor placements of
a spec on it: ``Shard(dim)`` on each mesh axis a tensor dim names,
``Replicate()`` on the others.  The port's models hold plain local
tensors; ``maybe_constrain`` redistributes only a DTensor, since the
reference's constraints change layout, never values.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


def _resolve(axes, mesh) -> tuple:
    """Map logical axis tuple -> partition spec valid on ``mesh``."""
    names = set(mesh.axis_names)
    out = []
    for a in axes:
        if a == "batch":
            out.append(("pod", "data") if "pod" in names else
                       ("data" if "data" in names else None))
        elif isinstance(a, tuple):
            sub = tuple(x for x in a if x in names)
            # a PartitionSpec holds a one-name tuple as the bare name
            out.append(sub[0] if len(sub) == 1 else (sub or None))
        elif a is None or a in names:
            out.append(a)
        else:
            out.append(None)
    return tuple(out)


def placements(spec, mesh) -> tuple:
    """DTensor placements of partition ``spec`` on ``mesh``, one per mesh
    axis.  A joint entry names its axes in mesh order (the rules' only
    joint entries are ('pod', 'data') and ('data', 'model')), the order in
    which DTensor nests two shardings of one dim."""
    out = []
    for name in mesh.axis_names:
        dim = next((i for i, a in enumerate(spec)
                    if a == name or (isinstance(a, tuple) and name in a)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


class Sharding(NamedTuple):
    """A spec on a mesh, and its DTensor placements there."""
    mesh: object
    spec: tuple
    placements: tuple

    @property
    def device_mesh(self):
        return self.mesh.device_mesh


def named(axes) -> Optional[Sharding]:
    if _MESH is None:
        return None
    spec = _resolve(axes, _MESH)
    return Sharding(_MESH, spec, placements(spec, _MESH))


def maybe_constrain(x, axes):
    """Redistribute a DTensor to ``axes`` if a mesh is active; anything
    else passes unchanged."""
    s = named(axes)
    if s is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(s.device_mesh, s.placements)


def act_spec(tun):
    return ("batch", "model" if tun.seq_parallel else None, None)


# ---------------------------------------------------------------------------
# tree walking
# ---------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def tree_map_with_path(fn, tree, path=()):
    """``fn(path_names, leaf)`` over nested dicts and tuples, keeping the
    structure; tuple positions count as the names "0", "1", ...  Leaves
    are tensors (or anything with a ``shape``) and ints."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map_with_path(fn, v, path + (str(i),))
                     for i, v in enumerate(tree))
    return fn(path, tree)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_IN_MATS = {"wq", "wk", "wv", "wi", "wg", "in_proj", "router", "patch_proj",
            "frame_proj", "head", "lora_a"}
_OUT_MATS = {"wo", "out_proj"}


def _param_axes(path_names, shape):
    name = path_names[-1]
    in_moe = "moe" in path_names and "shared" not in path_names \
        and "dense" not in path_names
    if name == "embed":
        base = ("model", "data")
    elif name == "conv_w":
        base = (None, None, "model")
    elif name == "lora_b":
        base = (None, "model")
    elif in_moe and name in ("wi", "wg"):
        base = ("model", "data", None)        # (E, D, Fe): EP over model
    elif in_moe and name == "wo":
        base = ("model", None, "data")        # (E, Fe, D)
    elif name in _IN_MATS:
        base = ("data", "model")
    elif name in _OUT_MATS:
        base = ("model", "data")
    else:
        base = (None,) * min(len(shape), 1)   # norms/biases/scalars: replicate
        return (None,) * (len(shape) - len(base)) + base
    lead = len(shape) - len(base)
    assert lead >= 0, (path_names, shape)
    return (None,) * lead + base


def param_axes_tree(params, zero3: bool = True):
    """Tree of logical-axis tuples parallel to ``params`` (any leaves with
    a shape: meta tensors too)."""
    def rule(path, leaf):
        axes = _param_axes(path, _shape(leaf))
        if not zero3:
            axes = tuple(None if a == "data" else a for a in axes)
        return axes
    return tree_map_with_path(rule, params)


def param_shardings(params, zero3: bool = True):
    return tree_shardings(param_axes_tree(params, zero3))


_NON_PARAM_TOP = {"count", "step", "rng"}


def state_axes_tree(state, zero3: bool = True):
    """Axes for a full train state {"params", "opt": {"m","v","count"}, "ef"}.

    Optimizer moments mirror the parameter sharding; int8 moment scales
    (trailing tuple index "1") drop the last axis.
    """
    def rule(names, leaf):
        shape = _shape(leaf)
        if names[0] in _NON_PARAM_TOP or names[-1] in _NON_PARAM_TOP:
            return ()
        # strip trailing tuple indices (int8 moment (q, scale) pairs)
        core = list(names)
        tup = []
        while core and core[-1].isdigit():
            tup.append(core.pop())
        if not core:
            return (None,) * len(shape)
        axes = _param_axes(tuple(core), shape)
        if tup and tup[-1] == "1":  # scale leaf: param axes minus last dim
            axes = axes[:-1] + (None,)
        if not zero3:
            axes = tuple(None if a == "data" else a for a in axes)
        return axes
    return tree_map_with_path(rule, state)


# ---------------------------------------------------------------------------
# input / cache specs
# ---------------------------------------------------------------------------


def _tp_size() -> int:
    return int(_MESH.shape.get("model", 1)) if _MESH is not None else 1


def _cache_axes(name: str, shape):
    r = len(shape)
    if name in ("k", "v", "k0", "v0", "xk", "xv"):
        # (B, S, K, hd). When kv-heads divide tp, shard heads over 'model'
        # (zero-collective attention); otherwise shard the sequence
        # (context-parallel serving), which always divides and keeps the
        # per-step append local.
        tp = _tp_size()
        heads_ok = shape[r - 2] % tp == 0
        if shape[r - 4] == 1:
            base = ((None, "data", "model", None) if heads_ok else
                    (None, ("data", "model"), None, None))
        else:
            base = (("batch", None, "model", None) if heads_ok else
                    ("batch", "model", None, None))
    elif name == "ssm":
        b = "batch" if shape[r - 4] > 1 else None
        base = (b, "model", None, None)           # (B, H, N, P)
    elif name == "conv":
        b = "batch" if shape[r - 3] > 1 else None
        base = (b, None, "model")                 # (B, k-1, Cd)
    elif name == "pos":
        return ()
    else:
        base = ("batch",) + (None,) * max(r - 1, 0)
        base = base[:r]
    return (None,) * (r - len(base)) + base


def cache_axes_tree(cache):
    return tree_map_with_path(
        lambda path, leaf: _cache_axes(path[-1], _shape(leaf)), cache)


def batch_axes_tree(batch):
    def rule(path, leaf):
        shape = _shape(leaf)
        if path[-1] == "pos" or len(shape) == 0:
            return ()
        if shape[0] == 1:  # unshardable unit batch (long-context decode)
            return (None,) * len(shape)
        return ("batch",) + (None,) * (len(shape) - 1)
    return tree_map_with_path(rule, batch)


def _is_axes(x) -> bool:
    """An axes tuple holds str/None entries (or tuples of ONLY str, e.g.
    ('data','model') joint sharding).  This distinguishes axes from tree
    tuples like int8-moment (q, scale) pairs, whose elements are themselves
    axes tuples containing None."""
    if not isinstance(x, tuple):
        return False
    return all(e is None or isinstance(e, str) or
               (isinstance(e, tuple) and e and
                all(isinstance(s, str) for s in e)) for e in x)


def tree_shardings(axes_tree):
    """``named`` of every axes tuple of ``axes_tree``, in its structure."""
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(v) for k, v in axes_tree.items()}
    if _is_axes(axes_tree):
        return named(axes_tree)
    return tuple(tree_shardings(v) for v in axes_tree)


def distribute(x, sharding: Optional[Sharding]):
    """``x`` as a DTensor with ``sharding``'s placements (every rank holds
    the whole ``x``); ``x`` itself where there is no sharding or ``x`` is
    not a tensor."""
    if sharding is None or not isinstance(x, torch.Tensor):
        return x
    return distribute_tensor(x, sharding.device_mesh,
                             list(sharding.placements))


def distribute_tree(tree, shardings):
    """``distribute`` over ``tree`` and ``shardings``, a tree of the same
    nested dicts and tuples (``tree_shardings``'s)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(distribute_tree(v, s) for v, s in zip(tree, shardings))
    return distribute(tree, shardings)
