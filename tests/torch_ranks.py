"""The port's side of ``tests/test_torch_distributed.py``: work for each
rank of a gloo process group on the CPU, one spawned process a rank.

Each worker joins the group through a file store (``init_method=
file://...``, so concurrent test runs never share a port), reads the
reference's inputs and outputs from ``ref.npz`` (and its checkpoints),
runs the port on them and writes what it measured to
``port<world>_<rank>.json``.  Imports torch and the port only.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import DEFAULT_TUNABLES
from repro_torch.kermit.serving import tiny_config
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import moe as MOE
from repro_torch.optim.adamw import OptConfig, tree_leaves
from repro_torch.optim.compression import compressed_psum
from repro_torch.runtime.checkpoint import CheckpointManager, _paths
from repro_torch.runtime.fault import elastic_restore
from repro_torch.sharding import rules
from repro_torch.train.pipeline import gpipe_apply, stage_split
from repro_torch.train.step import (init_train_state, loss_and_grads,
                                    make_train_step)

PSUM_SCALES = (0.01, 0.3, 1.0, 10.0)
MOE_MESHES = ((1, 4), (2, 2))
MOE_CFS = (1.25, 64.0)
PIPE = dict(L=8, D=16, B=12, S=4, M=4)
TRAIN_OC = dict(lr=1e-3, warmup=0)


def _nested(flat: dict, prefix: str) -> dict:
    """The entries ``<prefix>/a/b`` of ``flat`` as a nested dict of CPU
    tensors."""
    out = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = torch.from_numpy(np.array(a))
    return out


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _world4(rank: int, ref: dict) -> dict:
    out = {}
    for t in range(len(PSUM_SCALES)):
        y = compressed_psum(torch.from_numpy(ref[f"psum_x{t}"][rank]))
        want = ref[f"psum_y{t}"][rank]
        out[f"psum{t}_equal"] = bool(np.array_equal(y.numpy(), want))
        out[f"psum{t}_max_diff"] = _max_diff(y.numpy(), want)

    cfg = tiny_config("deepseek-moe-16b")
    p = _nested(ref, "moe_p")
    x = torch.from_numpy(ref["moe_x"])
    for shape in MOE_MESHES:
        rules.set_mesh(make_mesh(shape, ("data", "model"), "cpu"))
        for cf in MOE_CFS:
            with torch.no_grad():
                y, aux = MOE.moe_apply(p, x, cfg, capacity_factor=cf)
            tag = f"moe_{shape[0]}x{shape[1]}_{cf}"
            out[tag + "_max_diff"] = _max_diff(y, ref[tag])
            out[tag + "_aux_diff"] = _max_diff(aux, ref[tag + "_aux"])
            out[tag + "_vs_single"] = _max_diff(y, ref[f"moe_single_{cf}"])
        rules.set_mesh(None)

    ws = torch.from_numpy(ref["pipe_w"])
    xp = torch.from_numpy(ref["pipe_x"])

    def stage_fn(w_stage, h):                 # w_stage: (L/S, D, D)
        for w in w_stage:
            h = torch.tanh(h @ w)
        return h
    mesh = make_mesh((PIPE["S"],), ("stage",), "cpu")
    y = gpipe_apply(stage_split({"w": ws}, PIPE["S"])["w"], xp, stage_fn,
                    mesh=mesh, n_microbatches=PIPE["M"])
    seq = stage_fn(ws, xp)
    out["pipe_vs_sequential"] = _max_diff(y, seq)
    out["pipe_vs_reference"] = _max_diff(y, ref["pipe_out"])
    out["pipe_vs_reference_sequential"] = _max_diff(y, ref["pipe_seq"])
    return out


def _train_template(cfg, oc, tun):
    return init_train_state(torch.Generator().manual_seed(1), cfg, oc, tun)


def _world2(rank: int, ref: dict, ref_dir: Path, out_dir: Path) -> dict:
    out = {}
    # one train step of tiny deepseek-moe-16b under a (1, 2) mesh, from the
    # reference's initial state and batch
    cfg = tiny_config("deepseek-moe-16b")
    oc = OptConfig(**TRAIN_OC)
    tun = DEFAULT_TUNABLES
    mgr = CheckpointManager(ref_dir / "train")
    state, _ = mgr.restore(_train_template(cfg, oc, tun), step=0)
    want, _ = mgr.restore(_train_template(cfg, oc, tun), step=1)
    batch = {k: torch.from_numpy(ref[f"train_{k}"])
             for k in ("tokens", "targets", "mask")}
    rules.set_mesh(make_mesh((1, 2), ("data", "model"), "cpu"))
    new, metrics = make_train_step(cfg, oc, tun, device="cpu")(state, batch)
    _, _, grads = loss_and_grads(state["params"], cfg, batch, tun)
    rules.set_mesh(None)
    out["train_loss"] = float(metrics["loss"])
    out["train_loss_diff"] = abs(float(metrics["loss"]) - float(
        ref["train_loss"]))
    ref_grads = dict(_paths(_nested(ref, "train_grad")))
    worst = {}
    for key, g in _paths(grads):
        want_g = ref_grads[key].numpy()
        excess = np.abs(g.numpy() - want_g) - (1e-6 + 1e-4 * np.abs(want_g))
        worst[key] = float(excess.max())
    out["train_grads_worst"] = max(worst.items(), key=lambda kv: kv[1])
    out["train_grads_close"] = max(worst.values()) <= 0
    signal = {key: np.abs(g.numpy()) > 1e-6 for key, g in ref_grads.items()}
    want_p = dict(_paths(want["params"]))
    pairs = [(key, a.numpy(), want_p[key].numpy())
             for key, a in _paths(new["params"])]
    out["train_params_max_diff"] = max(_max_diff(a, b) for _, a, b in pairs)
    out["train_params_signal_max_diff"] = max(
        float(np.abs(a - b)[signal[key]].max(initial=0.0))
        for key, a, b in pairs)
    flat = torch.cat([a.reshape(-1) for a in tree_leaves(new["params"])])
    every = [torch.empty_like(flat) for _ in range(2)]
    dist.all_gather(every, flat)
    out["train_params_equal_across_ranks"] = bool(torch.equal(*every))

    # save a tiny qwen2 train state sharded over 'data' on both ranks, lose
    # the second rank, restore on the first alone onto a one-rank mesh
    qcfg = tiny_config("qwen2-1.5b")
    src = init_train_state(torch.Generator().manual_seed(0), qcfg, oc, tun)
    axes = rules.state_axes_tree(src)
    rules.set_mesh(make_mesh((2, 1), ("data", "model"), "cpu"))
    sharded = rules.distribute_tree(src, rules.tree_shardings(axes))
    out["saved_sharded_leaves"] = sum(
        a.placements[0].is_shard() for _, a in _paths(sharded)
        if isinstance(a, torch.Tensor))
    ckpt = CheckpointManager(out_dir / "shrink")
    ckpt.save(5, sharded, {"mesh": "2x1"})
    rules.set_mesh(None)
    dist.destroy_process_group()
    if rank == 0:
        restored, meta = elastic_restore(
            ckpt, _train_template(qcfg, oc, tun), make_host_mesh("cpu"),
            axes)
        rules.set_mesh(None)
        a = [v for _, v in _paths(src)]
        b = [v.full_tensor() if hasattr(v, "full_tensor") else v
             for _, v in _paths(restored)]
        out["restore_step"] = int(meta["step"])
        out["restore_leaves"] = len(b)
        out["restore_bitwise"] = len(a) == len(b) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(a, b))
        out["restore_one_rank"] = all(
            v.device_mesh.size() == 1 for _, v in _paths(restored)
            if isinstance(v, torch.Tensor))
        dist.destroy_process_group()
    return out


def worker(rank: int, world: int, store: str, ref_dir: str, out_dir: str):
    torch.set_num_threads(1)
    ref_dir, out_dir = Path(ref_dir), Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    with np.load(ref_dir / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    t0 = time.perf_counter()
    out = _world4(rank, ref) if world == 4 else \
        _world2(rank, ref, ref_dir, out_dir)
    out["seconds"] = time.perf_counter() - t0
    if dist.is_initialized():
        dist.destroy_process_group()
    (out_dir / f"port{world}_{rank}.json").write_text(json.dumps(out))


def run_ranks(world: int, store: Path, ref_dir: Path, out_dir: Path,
              timeout: float = 240.0) -> list:
    """Spawn ``world`` ranks of ``worker`` and wait at most ``timeout``
    seconds; returns each rank's results."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(worker, args=(world, str(store), str(ref_dir),
                                           str(out_dir)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [json.loads((out_dir / f"port{world}_{r}.json").read_text())
            for r in range(world)]

