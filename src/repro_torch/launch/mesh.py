"""Device meshes: named axes over torch.distributed process groups.

Port of ``repro/launch/mesh.py``.  A :class:`Mesh` wraps a
``torch.distributed.device_mesh.DeviceMesh`` and offers what the sharding
rules (``repro_torch.sharding.rules``) read of a jax ``Mesh``:
``axis_names``, ``shape`` as a mapping from axis name to size, and the
``device``; and what the collectives need: one process group per axis
(``group("model")``) or over several axes at once (``group(("pod",
"data"))``, the batch's axes), and this rank's coordinate on an axis.
DTensor placements live on its ``device_mesh``.

A DeviceMesh needs a live default process group.  ``make_mesh`` uses the
one the caller started (``torch.distributed.init_process_group``, one
process per rank).  With none live and a mesh of one device, it starts a
one-rank group on an in-memory ``HashStore``: NCCL for a CUDA device, gloo
for the CPU.  So ``make_host_mesh()`` works in a fresh process with no
``MASTER_ADDR`` or ``RANK`` in the environment, and again in the same
process.  One card is a world of one for NCCL, which refuses two ranks on
one GPU; a mesh of several ranks runs one process per rank.

``ShapeMesh`` is a mesh of names and sizes alone, with no process group
and no device: what the sharding rules read, and all that the dry run
(``launch/dryrun.py``) needs of the production meshes.  It plays the part
of the reference's 512 forced host devices.

Functions, not module constants: importing this module starts no group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.dispatch import resolve_device


class Mesh:
    """Named axes over ``device_mesh``, whose ranks are laid out row-major
    (``arange(n).reshape(shape)``), as ``jax.make_mesh`` lays out devices."""

    def __init__(self, device_mesh: DeviceMesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self._joint = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def backend(self) -> str:
        # an axis's own group: a joint one would be created here, a
        # collective every rank would have to join
        return dist.get_backend(self.group(self.axis_names[0]))

    def coordinate(self, axes) -> int:
        """This rank's index along ``axes`` (a name, or names in mesh
        order, read row-major): its rank in ``group(axes)``."""
        axes = self._order(axes)
        if len(axes) == 1:
            return self.device_mesh.get_local_rank(axes[0])
        return dist.get_group_rank(self.group(axes), dist.get_rank())

    def group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates on every axis but ``axes``.  Its ranks ascend with
        their coordinates along ``axes``, read row-major."""
        axes = self._order(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._joint:
            self._joint[axes] = self._new_group(axes)
        return self._joint[axes]

    def _order(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown or not axes:
            raise ValueError(f"axes {axes} not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def _new_group(self, axes):
        # new_group is collective over the world: every rank creates every
        # subgroup, in the same order, and keeps its own
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        rows = self.device_mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(self.shape[a] for a in axes)).tolist()
        mine = None
        for row in rows:
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        return mine

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


class ShapeMesh:
    """Named axes and their sizes, nothing else: the rules' view of a mesh
    (``axis_names``, ``shape``) and its ``size``.  Nothing can run on it."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not name its axes "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape})"


def _start_one_rank_group(dev: torch.device) -> None:
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), world_size=1, rank=0)


def _check_backend(dev: torch.device) -> None:
    want = "nccl" if dev.type == "cuda" else "gloo"
    have = str(dist.get_backend())
    if want not in have:
        raise RuntimeError(
            f"the live process group's backend is {have!r}; a {dev.type} "
            f"mesh runs on {want}")


def make_mesh(shape, axis_names, device=None) -> Mesh:
    """A mesh of ``shape`` with ``axis_names`` over the live process group's
    ranks (``device=None``: CUDA).  With no group live, only a one-device
    mesh can be made, on a one-rank group this call starts."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not name its axes "
                         f"{axis_names}")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} devices needs a process group of {n} ranks: "
                "start one with torch.distributed.init_process_group")
        _start_one_rank_group(dev)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"mesh needs {n} devices, found {world}")
    _check_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                    mesh_dim_names=axis_names)
    return Mesh(dm, dev)


def _production_layout(multi_pod: bool) -> tuple:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: (16, 16) = ('data', 'model') = 256 devices; multi-pod:
    (2, 16, 16) = ('pod', 'data', 'model') = 512, the 'pod' axis carrying
    only data-parallel gradient reduction.  Raises below that many ranks."""
    shape, axes = _production_layout(multi_pod)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(f"mesh needs {n} devices, found {world}")
    return make_mesh(shape, axes, device)


def make_shape_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The production mesh's axes and sizes (``make_production_mesh``'s)
    as a ``ShapeMesh``: no ranks needed."""
    return ShapeMesh(*_production_layout(multi_pod))


def make_host_mesh(device=None) -> Mesh:
    """Degenerate one-device ('data', 'model') mesh (1, 1) for smoke tests
    of the sharded code path."""
    return make_mesh((1, 1), ("data", "model"), device)
