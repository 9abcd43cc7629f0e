"""Checkpointing: atomic, keep-last-k, resumable.

Port of ``repro/runtime/checkpoint.py``, in the reference's file format, so
each package reads the other's checkpoints:

Layout: <dir>/step_<n>/arrays.npz (flattened state, '/'-joined key paths)
        <dir>/step_<n>/meta.json  (step, pipeline state, tunables, extras)

Key paths are the reference's (``jax.tree_util`` paths): dict keys in
sorted order, tuple items by index, so ``params/layers/attn/wq`` and an
int8 moment's codes and scales ``opt/m/layers/attn/wq/0`` and ``…/1``.
bfloat16 leaves are stored as numpy stores the reference's (ml_dtypes)
bf16 arrays: as 2-byte void (``|V2``) records of the same bits.  Writes
go to step_<n>.tmp and are renamed into place, so a crash mid-save never
corrupts the latest checkpoint.

Checkpoints are stored unsharded.  A DTensor leaf is saved whole
(``full_tensor``, a collective every rank of its mesh joins), and under a
process group of several ranks only rank 0 writes, the others waiting at a
barrier until it has.  ``restore(..., shardings=)`` places each leaf on a
mesh (``repro_torch.sharding.rules.tree_shardings``), so a checkpoint
restores onto any mesh, larger or smaller than the one that saved it.
"""
from __future__ import annotations

import io
import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import distribute_tree

# reserved npz key carrying the snapshot's JSON metadata (utf-8 bytes)
_META_KEY = "__meta__"


def atomic_write_bytes(path: str | Path, data: bytes) -> Path:
    """Crash-consistent file write: temp file + flush + fsync + atomic
    rename.  A crash at any point leaves either the old file or the new one,
    never a torn mix — a leftover ``<name>.tmp`` is garbage the next write
    overwrites, not state anyone reads."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # fsync the directory so the rename itself survives power loss
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass                         # not every filesystem supports dir fsync
    return path


def atomic_write_text(path: str | Path, text: str) -> Path:
    return atomic_write_bytes(path, text.encode("utf-8"))


def _json_default(obj):
    """Coerce stray numpy leaves (event details, journal entries) to plain
    JSON scalars so ``meta`` never needs pre-sanitising at call sites."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the reference would write: a tensor's values
    on the host (bf16 as ``|V2`` records of its bits), an int as int32."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def save_snapshot(path: str | Path, arrays: dict, meta: dict) -> Path:
    """Write a single-file snapshot (npz of named arrays + a JSON ``meta``
    dict under a reserved key) with the atomic temp+fsync+rename protocol."""
    buf = io.BytesIO()
    payload = {k: _to_numpy(v) for k, v in arrays.items()}
    if _META_KEY in payload:
        raise ValueError(f"array key {_META_KEY!r} is reserved for metadata")
    payload[_META_KEY] = np.frombuffer(
        json.dumps(meta, default=_json_default).encode("utf-8"),
        dtype=np.uint8)
    np.savez(buf, **payload)
    return atomic_write_bytes(path, buf.getvalue())


def load_snapshot(path: str | Path) -> tuple[dict, dict]:
    """Read a ``save_snapshot`` file -> (arrays, meta)."""
    with np.load(Path(path), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
    return arrays, meta


def _paths(tree, prefix=()):
    """(key path, leaf) pairs in the reference's order: dict keys sorted,
    tuple items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _from_numpy(arr: np.ndarray, like):
    """``arr`` as a leaf like ``like`` (its dtype and device; an int stays
    an int)."""
    if isinstance(like, int):
        return int(arr)
    if arr.dtype.kind == "V" and like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(like.device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.device,
                                                         like.dtype)


def _unflatten(template, flat: dict):
    """A tree shaped like ``template`` (tensors, tuples, ints) with the
    leaves of ``flat``, each checked against the template's shape."""
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(build(v, prefix + (str(i),))
                         for i, v in enumerate(t))
        key = "/".join(prefix)
        arr = flat[key]
        shape = () if isinstance(t, int) else tuple(t.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                             f"expected {shape}")
        return _from_numpy(arr, t)
    return build(template, ())


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def save(self, step: int, state, meta: Optional[dict] = None):
        final = self._step_dir(step)
        arrays = _flatten(state)
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        if ranks == 1 or dist.get_rank() == 0:
            tmp = final.with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **arrays)
            (tmp / "meta.json").write_text(json.dumps(
                dict(meta or {}, step=step)))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()
        if ranks > 1:
            dist.barrier()
        return final

    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "meta.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: Optional[int] = None,
                shardings=None):
        """(state, meta) of ``step`` (default: the latest), each leaf in
        the dtype and on the device of ``template``'s, and distributed
        with its sharding where ``shardings`` (a tree in ``template``'s
        structure) has one; (None, None) when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = self._step_dir(step)
        with np.load(d / "arrays.npz", allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        state = _unflatten(template, flat)
        if shardings is not None:
            state = distribute_tree(state, shardings)
        meta = json.loads((d / "meta.json").read_text())
        return state, meta

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
