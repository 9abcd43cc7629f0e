"""The port's dry run against the JAX package's.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 forced host
devices) when it is imported, so it runs in subprocesses, one per mesh, all
started together: ``probe_cost`` of reduced qwen2-1.5b (train, prefill and
decode) and reduced deepseek-moe-16b (train) at B = 8, S = 64 on meshes
(1, 1), (2, 2), (4, 1) and (1, 4) of ``jax.sharding.Mesh``; the first also
gives ``scale_units``, ``units_full`` and ``parse_tun`` for every arch.
The port runs the same probes here on ``ShapeMesh``es.

* Per-device FLOPs within 6 % (the port counts matmuls, XLA elementwise
  work too; measured -1.3 % to -4.9 %).
* Collective bytes 0 on (1, 1), and in total within [0.5, 2]x the
  reference's on each train mesh, each kind's ratio printed.  The port's
  are estimates from the sharding rules (zero3 gathers and gradient
  reductions over 'data', tensor-parallel partial sums over 'model'); the
  reference's are parsed from the partitioned HLO.
* Eager bytes against XLA's count, every case bounded on both sides.  On
  mesh (1, 1), the whole step: train and prefill within [1, 2]x XLA's
  fused count (measured 1.25-1.46x); decode within [0.3, 1)x (measured
  0.41x), since the reference's decode slices each layer's K and V out of
  the stacked cache and concatenates them back, copies that XLA counts
  and the port's in-place writes do not make (its probes grow by 6.63 MB
  from 1 to 2 layers and by 4.67 MB from 2 to 3, and the extrapolation
  carries the first).  On the other meshes the port divides its whole
  step by the devices, where XLA counts its partitioned program, which
  does at least its whole program over the devices and at most all of
  it: so each ratio lies within [0.4, 1]x the (1, 1) ratio (measured
  0.43-0.87; the 0.4 is the work that tensor parallelism replicates over
  'model', which the port divides by it).  Independently of XLA, a decode
  step of every arch moves its weights and its whole cache at least once
  and at most 6 times (measured 1.8-4.9).
* The 1-and-2-unit extrapolation equals the full-depth FLOPs on a
  homogeneous stack, and its bytes (within 3 % on train).
* ``lower_cell`` records for three full-width cells on the shape-only
  meshes carry the reference's keys and finite terms, and the rules' mesh
  is the caller's again after each.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.base import DEFAULT_TUNABLES, ShapeSpec, reduced
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding import rules
from torch.utils._pytree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 64, 8
MESHES = [(1, 1), (2, 2), (4, 1), (1, 4)]
PROBES = [(arch, kind) for arch, kinds in (
    ("qwen2-1.5b", ("train", "prefill", "decode")),
    ("deepseek-moe-16b", ("train",))) for kind in kinds]
TUN_ARGS = [[], ["remat=full", "microbatches=4"],
            ["seq_parallel=true", "attn_impl=pallas", "capacity_factor=1.5"],
            ["zero3=0", "donate=false", "attn_q_chunk=512"]]
FLOP_TOL = 0.06

REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.launch import dryrun as D   # sets XLA_FLAGS before jax loads
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs.base import DEFAULT_TUNABLES, ShapeSpec, reduced
from repro.configs.registry import ARCHS, get_config
from repro.optim.adamw import OptConfig
from repro.sharding import rules

job = json.loads(sys.argv[1])
ms = tuple(job["mesh"])
mesh = Mesh(np.array(jax.devices()[:ms[0] * ms[1]]).reshape(ms),
            ("data", "model"))
out = {"probes": []}
for arch, kind in job["probes"]:
    rules.set_mesh(mesh)
    cost, coll = D.probe_cost(reduced(get_config(arch)),
                              ShapeSpec("t", job["seq"], job["batch"], kind),
                              DEFAULT_TUNABLES, OptConfig(), mesh)
    rules.set_mesh(None)
    out["probes"].append([arch, kind, cost, coll])
if job["units"]:
    out["units"] = {a: {"scale": [dataclasses.asdict(
        D.scale_units(get_config(a), k)) for k in (1, 2)],
        "full": D.units_full(get_config(a))} for a in ARCHS}
    out["tun"] = [D.parse_tun(kv).as_dict() for kv in job["tun"]]
print("REFERENCE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def started():
    """The reference's runs, one subprocess per mesh, started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for i, ms in enumerate(MESHES):
        job = {"mesh": ms, "probes": PROBES, "seq": SEQ, "batch": BATCH,
               "units": i == 0, "tun": TUN_ARGS}
        procs[ms] = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, json.dumps(job)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    yield procs
    for p in procs.values():
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def port(started):
    """The port's probes, run while the reference's run."""
    out = {}
    for ms in MESHES:
        mesh = ShapeMesh(ms, ("data", "model"))
        for arch, kind in PROBES:
            out[arch, kind, ms] = D.probe_cost(
                reduced(get_config(arch)), ShapeSpec("t", SEQ, BATCH, kind),
                DEFAULT_TUNABLES, OptConfig(), mesh)
    return out


@pytest.fixture(scope="module")
def reference(started, port):
    """The reference's probes per mesh (and its units and tunables)."""
    out = {}
    for ms, p in started.items():
        stdout, stderr = p.communicate(timeout=600)
        line = [x for x in stdout.splitlines() if x.startswith("REFERENCE ")]
        assert p.returncode == 0 and line, stderr[-3000:]
        out[ms] = json.loads(line[0][len("REFERENCE "):])
    return out


def ref_probe(reference, arch, kind, ms):
    return next((c, l) for a, k, c, l in reference[ms]["probes"]
                if (a, k) == (arch, kind))


@pytest.mark.parametrize("arch", ARCHS)
def test_scale_units_and_units_full_equal_reference(reference, arch):
    ref = reference[(1, 1)]["units"][arch]
    cfg = get_config(arch)
    assert [dataclasses.asdict(D.scale_units(cfg, k)) for k in (1, 2)] == \
        ref["scale"]
    assert D.units_full(cfg) == ref["full"]


def test_parse_tun_equal_reference(reference):
    assert [D.parse_tun(kv).as_dict() for kv in TUN_ARGS] == \
        reference[(1, 1)]["tun"]


@pytest.mark.parametrize("ms", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,kind", PROBES)
def test_probe_flops_per_device_near_reference(reference, port, arch, kind,
                                               ms):
    ratio = port[arch, kind, ms][0]["flops"] / \
        ref_probe(reference, arch, kind, ms)[0]["flops"]
    print(f"{arch} {kind} {ms}: port/reference FLOPs per device {ratio:.4f}")
    assert abs(ratio - 1.0) <= FLOP_TOL


@pytest.mark.parametrize("ms", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,kind", PROBES)
def test_probe_collectives_against_reference(reference, port, arch, kind,
                                             ms):
    coll = port[arch, kind, ms][1]
    ref = ref_probe(reference, arch, kind, ms)[1]
    if ms == (1, 1):
        assert all(v == 0.0 for v in coll.values()), coll
        assert ref.get("total", 0.0) == 0.0
        return
    kinds = {k: (coll.get(k, 0.0), ref.get(k, 0.0)) for k in
             sorted(set(coll) | set(ref))}
    print(f"{arch} {kind} {ms}: port, reference bytes by kind {kinds}")
    ratio = coll["total"] / ref["total"]
    print(f"  total ratio {ratio:.3f}")
    assert coll["total"] > 0
    if kind == "train":
        assert 0.5 <= ratio <= 2.0


@pytest.mark.parametrize("ms", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,kind", PROBES)
def test_eager_bytes_against_reference(reference, port, arch, kind, ms):
    def ratio(m):
        return port[arch, kind, m][0]["bytes accessed"] / \
            ref_probe(reference, arch, kind, m)[0]["bytes accessed"]
    r, whole = ratio(ms), ratio((1, 1))
    print(f"{arch} {kind} {ms}: eager/XLA bytes per device {r:.3f}, "
          f"{r / whole:.3f} of the whole step's")
    if kind == "decode":
        assert 0.3 <= whole < 1.0
    else:
        assert 1.0 <= whole <= 2.0
    assert 0.4 * whole <= r <= whole


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_extrapolation_equals_full_depth(kind):
    """Reduced qwen2 is a homogeneous stack of 4 layers: the probes of 1
    and 2 extrapolate to its full-depth FLOPs."""
    cfg = reduced(get_config("qwen2-1.5b"))
    shape = ShapeSpec("t", SEQ, BATCH, kind)
    cost, _ = D.probe_cost(cfg, shape, DEFAULT_TUNABLES, OptConfig(),
                           ShapeMesh((1, 1), ("data", "model")))
    full = D.step_cost(D._lower(cfg, shape, DEFAULT_TUNABLES.replace(
        attn_unroll=True, layer_unroll=True), OptConfig())[0])
    assert cfg.n_layers == 4
    assert math.isclose(cost["flops"], full["flops"], rel_tol=1e-12)
    # prefill and decode are linear in depth from one layer; the train
    # step's bytes grow by 5.5 % more from one layer to two than from two to
    # three, so its extrapolation from 1 and 2 overshoots (2.5 % at 4 layers)
    ratio = cost["bytes accessed"] / full["bytes accessed"]
    print(f"{kind}: extrapolated/full-depth bytes {ratio:.5f}")
    assert abs(ratio - 1.0) <= (0.03 if kind == "train" else 1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_bytes_cover_weights_and_cache(arch):
    """A decode step reads every weight (the port's MoE runs every
    expert's capacity slots) and its whole cache at least once; the
    eager temporaries add at most 5 times as much."""
    cfg = reduced(get_config(arch))
    shape = ShapeSpec("t", SEQ, BATCH, "decode")
    cost, _ = D.probe_cost(cfg, shape, DEFAULT_TUNABLES, OptConfig(),
                           ShapeMesh((1, 1), ("data", "model")))
    params, cache, _ = D._lower(cfg, shape, DEFAULT_TUNABLES,
                                OptConfig())[0].args
    floor = sum(D._nbytes(t) for t in tree_leaves((params, cache)))
    ratio = cost["bytes accessed"] / floor
    print(f"{arch}: decode bytes / (weights + cache) {ratio:.3f}")
    assert 1.0 <= ratio <= 6.0


# the keys of the reference's record (repro/launch/dryrun.py:186-196)
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "tunables",
               "n_params_total", "n_params_active", "memory", "cost",
               "cost_raw_scan_once", "collectives", "roofline", "lower_s",
               "compile_s", "probe_s"}
MEMORY_KEYS = {"temp_size_in_bytes", "argument_size_in_bytes",
               "output_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes"}


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("qwen2-1.5b", "train_4k", False),
    ("deepseek-moe-16b", "decode_32k", True),
    ("mamba2-1.3b", "long_500k", False)])
def test_lower_cell_records(arch, shape, multi_pod):
    before = ShapeMesh((2, 2), ("data", "model"))
    rules.set_mesh(before)
    try:
        rec = D.lower_cell(arch, shape, multi_pod=multi_pod, verbose=False)
        # the shape-only mesh is the rules' only while the cell lowers
        assert rules.current_mesh() is before
    finally:
        rules.set_mesh(None)
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["chips"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["memory"]["generated_code_size_in_bytes"] is None
    assert rec["cost_raw_scan_once"] is None
    r = rec["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "useful_ratio"):
        assert math.isfinite(r[key]) and r[key] > 0, (key, r)
    assert r["bottleneck"] in ("compute", "memory", "collective")
    for key in ("temp_size_in_bytes", "argument_size_in_bytes",
                "output_size_in_bytes"):
        assert math.isfinite(rec["memory"][key]) and \
            rec["memory"][key] > 0, rec["memory"]
    # the state's (or parameters') shards: at least an even split of the
    # parameters' bf16 bytes, at most every byte of the state
    n = rec["n_params_total"]
    args = rec["memory"]["argument_size_in_bytes"]
    assert 2 * n / rec["chips"] <= args <= 10 * n + 1e9
    print(arch, shape, rec["mesh"], r, rec["memory"])


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan",
                                    "pairdist", "nbr_adjacency",
                                    "ssm_step"])
def test_kernel_wrappers_refuse_fake_cuda_tensors(kernel):
    """A fake tensor's data pointer is 0: each CUDA wrapper raises before
    it builds or launches anything."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import pairdist as P
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssm_step as SS

    def fake(*shape):
        return torch.empty(shape, device="cuda", dtype=torch.float32)
    with FakeTensorMode(), pytest.raises(RuntimeError, match="fake"):
        if kernel == "flash_attention":
            q = fake(1, 64, 2, 32)
            FA._flash_fwd(q, q, q)
        elif kernel == "ssd_scan":
            SSD._ssd_fwd_cuda(fake(1, 64, 2, 32), fake(1, 64, 2), fake(2),
                              fake(1, 64, 1, 16), fake(1, 64, 1, 16),
                              chunk=32)
        elif kernel == "pairdist":
            P._pairdist_cuda(fake(64, 8))
        elif kernel == "ssm_step":
            # one mixer of H 2, P 16, G 1, N 16, K 4: d_inner 32, Cd 64
            SS.ssm_step(fake(1, 98), fake(1, 3, 64), fake(1, 2, 16, 16),
                         fake(4, 1, 64), fake(64), fake(2), fake(2), fake(2),
                         fake(32), eps=1e-5)
        else:
            P._neighbor_adjacency_cuda(fake(64, 8), eps_sq=1.0, block=128)
