"""The port's distributed runtime against the JAX package, on gloo ranks.

The reference runs once, in a subprocess with four forced host devices
(``XLA_FLAGS`` and ``JAX_PLATFORMS=cpu`` set before jax is imported, meshes
built with ``jax.sharding.Mesh``), and writes its inputs and outputs to
``ref.npz``.  The port runs the same work as one spawned process a rank
(``tests/torch_ranks.py``): four ranks, then two, on gloo through a file
store.  Each case below reads their results.

* ``compressed_psum`` over 4 ranks equals the reference under ``shard_map``
  bit for bit (its sum is exact in int32, its scale the ranks' largest).
* The MoE's expert-parallel branch on tiny deepseek-moe-16b (E = 8, top-2,
  2 shared) at meshes (1, 4) and (2, 2), capacity factors 1.25 and 64:
  within 1e-6 of the reference's branch.  At (2, 2) and 1.25 each data
  shard takes its own capacity, so both differ from the single-device
  output there.
* GPipe (L = 8, D = 16, B = 12, S = 4 stages, M = 4 microbatches) within
  2e-5 of the sequential stack and of the reference's ``gpipe_apply``.
* One train step of tiny deepseek-moe-16b under a (1, 2) mesh on 2 ranks,
  from the reference's state and batch: loss within 1e-6 of the
  reference's step under its (1, 2) mesh; every gradient leaf within rtol
  1e-4 and atol 1e-6 of the reference's (``test_torch_train_step.py``'s
  tolerance), each rank holding the whole gradient of the experts it does
  not own; parameters within 1e-5 wherever the reference's gradient is
  above 1e-6 in size and within 2·lr everywhere, and equal on both ranks.
  (AdamW's first step is lr·g/(|g| + eps): where g is float noise about 0
  the step is too, in the single-device port as well, which is off by
  1.2e-5 at a gradient of 1.6e-8.)
* A train state saved sharded over 'data' by 2 ranks restores bitwise on
  one surviving rank, onto a one-rank mesh (``tests/test_fault.py``'s
  shrink).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_ranks as R

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.base import DEFAULT_TUNABLES
from repro.kermit.serving import tiny_config
from repro.models import model as M
from repro.models import moe as MOE
from repro.optim import compression as C
from repro.optim.adamw import OptConfig
from repro.runtime.checkpoint import CheckpointManager
from repro.sharding import rules
from repro.train.pipeline import gpipe_apply, stage_split
from repro.train.step import init_train_state, make_train_step

out = Path(sys.argv[1])
psum_scales, moe_meshes, moe_cfs = eval(sys.argv[2]), eval(sys.argv[3]), \
    eval(sys.argv[4])
pipe, train_oc = eval(sys.argv[5]), eval(sys.argv[6])
devs = np.array(jax.devices()[:4])
assert len(devs) == 4
res = {}

# compressed_psum over a 4-device axis
rng = np.random.default_rng(0)
f = jax.jit(MOE.shard_map(lambda a: C.compressed_psum(a[0], "pod")[None],
                          Mesh(devs, ("pod",)), in_specs=P("pod"),
                          out_specs=P("pod")))
for t, scale in enumerate(psum_scales):
    x = (rng.normal(size=(4, 33)) * scale
         * rng.uniform(0.5, 2.0, size=(4, 1))).astype(np.float32)
    res[f"psum_x{t}"] = x
    res[f"psum_y{t}"] = np.asarray(f(jnp.asarray(x)))

# the MoE: single-device and expert-parallel
cfg = tiny_config("deepseek-moe-16b")
p = MOE.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
    res["moe_p/" + "/".join(k.key for k in path)] = np.asarray(leaf)
x = np.random.default_rng(1).normal(size=(2, 8, cfg.d_model)).astype(
    np.float32)
res["moe_x"] = x

def moe(cf):   # traced under the rules' mesh of the moment
    return jax.jit(lambda p, x: MOE.moe_apply(p, x, cfg, capacity_factor=cf))

for cf in moe_cfs:
    y, _ = moe(cf)(p, jnp.asarray(x))
    res[f"moe_single_{cf}"] = np.asarray(y)
    for shape in moe_meshes:
        rules.set_mesh(Mesh(devs.reshape(shape), ("data", "model")))
        y, aux = moe(cf)(p, jnp.asarray(x))
        rules.set_mesh(None)
        res[f"moe_{shape[0]}x{shape[1]}_{cf}"] = np.asarray(y)
        res[f"moe_{shape[0]}x{shape[1]}_{cf}_aux"] = np.asarray(aux)

# GPipe over a 4-device 'stage' axis (tests/test_pipeline.py's script)
L, D, B = pipe["L"], pipe["D"], pipe["B"]
ws = jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) * (D ** -0.5)
xp = jax.random.normal(jax.random.PRNGKey(1), (B, D))

def layer(w, h):
    return jnp.tanh(h @ w)

def stage_fn(p_stage, h):
    return lax.scan(lambda h, w: (layer(w, h), None), h, p_stage)[0]

seq = jax.jit(stage_fn)(ws, xp)
staged = stage_split({"w": ws}, pipe["S"])
res["pipe_out"] = np.asarray(jax.jit(lambda w, h: gpipe_apply(
    w, h, stage_fn, mesh=Mesh(devs, ("stage",)),
    n_microbatches=pipe["M"]))(staged["w"], xp))
res["pipe_seq"], res["pipe_w"], res["pipe_x"] = (
    np.asarray(seq), np.asarray(ws), np.asarray(xp))

# one train step under a (1, 2) mesh
oc = OptConfig(**train_oc)
state = init_train_state(jax.random.PRNGKey(0), cfg, oc, DEFAULT_TUNABLES)
mgr = CheckpointManager(out / "train")
mgr.save(0, state)
brng = np.random.default_rng(2)
batch = {"tokens": brng.integers(0, cfg.vocab, (2, 8)).astype(np.int32),
         "targets": brng.integers(0, cfg.vocab, (2, 8)).astype(np.int32),
         "mask": (brng.random((2, 8)) > 0.1).astype(np.float32)}
for k, v in batch.items():
    res[f"train_{k}"] = v
jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
rules.set_mesh(Mesh(devs[:2].reshape(1, 2), ("data", "model")))
new, m = jax.jit(make_train_step(cfg, oc, DEFAULT_TUNABLES))(state, jbatch)
grads = jax.jit(jax.grad(lambda p: M.loss_fn(p, cfg, jbatch,
                                             DEFAULT_TUNABLES)[0]))(
    state["params"])
rules.set_mesh(None)
for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
    res["train_grad/" + "/".join(k.key for k in path)] = np.asarray(leaf)
res["train_loss"] = np.asarray(m["loss"])
mgr.save(1, new)
np.savez(out / "ref.npz", **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run, then the port's on 4 and on 2 ranks."""
    d = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d), repr(R.PSUM_SCALES),
         repr(R.MOE_MESHES), repr(R.MOE_CFS), repr(R.PIPE),
         repr(R.TRAIN_OC)],
        capture_output=True, text=True, timeout=300, env=env)
    assert "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    return {w: R.run_ranks(w, d / f"store{w}", d, d) for w in (4, 2)}


@pytest.mark.parametrize("trial", range(len(R.PSUM_SCALES)))
def test_compressed_psum_bit_equal_to_reference(runs, trial):
    for rank in runs[4]:
        assert rank[f"psum{trial}_equal"], rank[f"psum{trial}_max_diff"]


@pytest.mark.parametrize("cf", R.MOE_CFS)
@pytest.mark.parametrize("shape", R.MOE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_expert_parallel_moe_matches_reference(runs, shape, cf):
    tag = f"moe_{shape[0]}x{shape[1]}_{cf}"
    worst = max(r[tag + "_max_diff"] for r in runs[4])
    print(f"{tag}: max |Δy| against the reference's branch {worst}")
    assert worst <= 1e-6
    assert max(r[tag + "_aux_diff"] for r in runs[4]) <= 1e-6
    if shape == (2, 2) and cf == 1.25:
        # each data shard's own capacity drops other tokens
        assert min(r[tag + "_vs_single"] for r in runs[4]) > 0.1


@pytest.mark.parametrize("against", ["sequential", "reference",
                                     "reference_sequential"])
def test_gpipe_matches_sequential_and_reference(runs, against):
    for rank in runs[4]:
        assert rank[f"pipe_vs_{against}"] <= 2e-5, rank


@pytest.mark.parametrize("what", ["loss", "grads", "params", "ranks"])
def test_train_step_under_a_mesh_matches_reference(runs, what):
    for rank in runs[2]:
        if what == "loss":
            assert rank["train_loss_diff"] <= 1e-6, rank["train_loss"]
        elif what == "grads":
            assert rank["train_grads_close"], rank["train_grads_worst"]
        elif what == "params":
            assert rank["train_params_signal_max_diff"] <= 1e-5, rank
            assert rank["train_params_max_diff"] <= 2 * R.TRAIN_OC["lr"]
        else:
            assert rank["train_params_equal_across_ranks"]


def test_two_rank_checkpoint_restores_bitwise_on_one_rank(runs):
    first, second = runs[2]
    assert first["saved_sharded_leaves"] == \
        second["saved_sharded_leaves"] > 0
    assert first["restore_step"] == 5 and first["restore_bitwise"]
    assert first["restore_one_rank"] and first["restore_leaves"] > 0
    assert "restore_step" not in second       # the lost rank restores nothing
