"""The port's hillclimb and memory-budget walk against the JAX package's.

The reference's ``repro.launch.hillclimb`` and ``verify_budget`` set
``XLA_FLAGS`` when they are imported, so they run in one subprocess.  Both
packages get the same deterministic ``probe_cost`` stub (``STUB``) and the
same stubbed ``lower_cell``, so the search itself is compared:

* ``knob_space`` is equal for every arch × kind;
* ``RooflineExecutor`` + ``Explorer(knob_space, max_passes=2)
  .global_search`` from ``DEFAULT_TUNABLES`` gives an equal winner, cost,
  evaluation count and trace (tunables, ``est_s``, bottleneck, in order),
  the port at the reference's TPU v5e constants (``roofline.V5E``);
* ``verify_budget.main`` over that trace chooses the same candidate and
  writes an equal ``budgeted`` record.

The card's path (``--card``) raises without CUDA unless ``device="cpu"``
is given; on the CPU its real step (``CardCell``) measures the temporary
bytes that ``MemTracker`` estimates for the fake step, a candidate that
fits runs exactly two steps (the second timed), the walk takes the
hillclimb's measurement of its winner instead of stepping it again, and
neither path leaves its mesh behind as the rules' mesh.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.roofline import V5E
from repro_torch.configs.base import (DEFAULT_TUNABLES, ShapeSpec, Tunables,
                                      reduced)
from repro_torch.configs.registry import ARCHS, get_config, get_shape
from repro_torch.core.explorer import Explorer
from repro_torch.kermit.executor import ExecutorObjective
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb as H
from repro_torch.launch import verify_budget as VB
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding import rules

import torch_parity  # noqa: F401 (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")
CELLS = [("qwen2-1.5b", "train_4k"), ("deepseek-moe-16b", "train_4k"),
         ("mamba2-1.3b", "train_4k"), ("qwen2-1.5b", "prefill_32k"),
         ("deepseek-moe-16b", "decode_32k")]
VERIFIED = [("qwen2-1.5b", "train_4k"), ("mamba2-1.3b", "train_4k")]
MF = 1.0e18

STUB = r'''
def probe_stub(cfg, shape, tun, oc, mesh):
    r = {"none": 1.0, "dots": 1.25, "full": 1.5}[tun.remat]
    flops = 2.0e14 * r * (1.0 + 0.02 * tun.microbatches) * \
        (0.9 + 0.1 * tun.capacity_factor)
    byts = 8.0e11 * (1.6 if tun.remat == "none" else 1.0) * \
        (1.0 + 0.5 / tun.microbatches) * (tun.attn_q_chunk / 1024.0) ** 0.25 \
        * (tun.ssm_chunk / 256.0) ** 0.1
    coll = 4.0e10 * (1.1 if tun.zero3 else 1.0) * \
        (0.9 if tun.seq_parallel else 1.0)
    return ({"flops": flops, "bytes accessed": byts},
            {"all-gather": coll / 4, "all-reduce": 3 * coll / 4,
             "total": coll})


def lower_stub(arch, shape, *, multi_pod, tun, verbose=True, **kw):
    temp = 40e9 * {"none": 2.0, "dots": 1.0, "full": 0.5}[tun.remat] / \
        tun.microbatches * (1.5 if not tun.zero3 else 1.0)
    return {"memory": {"temp_size_in_bytes": temp},
            "roofline": {"compute_s": 1.0 + 0.1 * tun.microbatches,
                         "memory_s": 1.2, "collective_s": 0.5}}
'''

REFERENCE = r"""
import json, os, sys
from pathlib import Path
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.launch import hillclimb as H   # sets XLA_FLAGS before jax loads
from repro.launch import verify_budget as VB
from repro.configs.base import DEFAULT_TUNABLES
from repro.configs.registry import ARCHS, get_config, get_shape
from repro.core.explorer import Explorer
from repro.kermit.executor import ExecutorObjective
from repro.optim.adamw import OptConfig

exec(sys.argv[2])
cells, verified, mf = json.loads(sys.argv[3])
out = {"space": {f"{a}/{k}": H.knob_space(get_config(a), k) for a in ARCHS
                 for k in ("train", "prefill", "decode")}, "search": {},
       "budgeted": {}}
H.probe_cost = probe_stub
VB.OUT_ROOT, VB.lower_cell = Path(sys.argv[1]), lower_stub
for arch, shape_name in cells:
    cfg, shape = get_config(arch), get_shape(shape_name)
    trace = []
    rex = H.RooflineExecutor(cfg, shape, OptConfig(), None, 256, mf, trace)
    res = Explorer(H.knob_space(cfg, shape.kind), max_passes=2) \
        .global_search(ExecutorObjective(rex), DEFAULT_TUNABLES)
    out["search"][f"{arch}/{shape_name}"] = {
        "best": res.best.as_dict(), "cost": res.cost,
        "evaluations": res.evaluations, "trace": trace}
    if [arch, shape_name] in verified:
        path = Path(sys.argv[1]) / "16x16" / f"{arch}__{shape_name}__opt.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"hillclimb": {
            "baseline": trace[0], "trace": trace}}))
        VB.main(["--arch", arch, "--shape", shape_name, "--budget-gb", "16"])
        out["budgeted"][f"{arch}/{shape_name}"] = json.loads(
            path.read_text())["hillclimb"]["budgeted"]
print("REFERENCE " + json.dumps(out))
"""

ns = {}
exec(STUB, ns)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_hillclimb")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d), STUB,
         json.dumps([CELLS, VERIFIED, MF])],
        capture_output=True, text=True, timeout=600, env=env)
    line = [x for x in proc.stdout.splitlines() if x.startswith("REFERENCE ")]
    assert proc.returncode == 0 and line, proc.stderr[-3000:]
    return json.loads(line[0][len("REFERENCE "):])


def port_search(arch, shape_name):
    cfg, shape = get_config(arch), get_shape(shape_name)
    trace = []
    rex = H.RooflineExecutor(cfg, shape, OptConfig(), None, 256, MF, trace,
                             chip=V5E)
    res = Explorer(H.knob_space(cfg, shape.kind), max_passes=2) \
        .global_search(ExecutorObjective(rex), DEFAULT_TUNABLES)
    return res, trace


def rows(trace):
    return [(t["tun"], t["est_s"], t["bottleneck"]) for t in trace]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_knob_space_equal_reference(reference, arch, kind):
    assert H.knob_space(get_config(arch), kind) == \
        reference["space"][f"{arch}/{kind}"]


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_search_equal_reference(reference, monkeypatch, arch, shape_name):
    monkeypatch.setattr(H, "probe_cost", ns["probe_stub"])
    res, trace = port_search(arch, shape_name)
    ref = reference["search"][f"{arch}/{shape_name}"]
    print(f"{arch} {shape_name}: best est {res.cost:.6f} s after "
          f"{res.evaluations} evaluations")
    assert res.best.as_dict() == ref["best"]
    assert res.cost == ref["cost"]
    assert res.evaluations == ref["evaluations"] == len(trace)
    assert rows(trace) == rows(ref["trace"])


@pytest.mark.parametrize("arch,shape_name", VERIFIED)
def test_verify_budget_equal_reference(reference, monkeypatch, tmp_path,
                                       arch, shape_name):
    monkeypatch.setattr(H, "probe_cost", ns["probe_stub"])
    monkeypatch.setattr(VB, "OUT_ROOT", tmp_path)
    monkeypatch.setattr(VB, "lower_cell", ns["lower_stub"])
    _, trace = port_search(arch, shape_name)
    path = tmp_path / "16x16" / f"{arch}__{shape_name}__opt.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"hillclimb": {"baseline": trace[0],
                                              "trace": trace}}))
    VB.main(["--arch", arch, "--shape", shape_name, "--budget-gb", "16"])
    rec = json.loads(path.read_text())["hillclimb"]
    assert rec["budgeted"] is not None
    assert rec["budgeted"] == reference["budgeted"][f"{arch}/{shape_name}"]
    print(f"{arch} {shape_name}: chose {rec['budgeted']['tun']['remat']}, "
          f"{rec['budgeted']['tun']['microbatches']} microbatches after "
          f"{len(rec['tried'])} tries")


def test_card_path_needs_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the card's path would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        H.hillclimb("qwen2-1.5b", "train_4k", card=True)
    monkeypatch.setattr(VB, "OUT_ROOT", tmp_path)
    path = tmp_path / "1x1" / "qwen2-1.5b__train_4k__opt.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"hillclimb": {
        "baseline": {"est_s": 1.0},
        "trace": [{"tun": DEFAULT_TUNABLES.as_dict(), "est_s": 1.0}]}}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VB.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--card"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.CardCell(reduced(get_config("qwen2-1.5b")),
                   ShapeSpec("t", 32, 2, "train"))


def test_card_shape_is_one_data_shard():
    shape = D.card_shape(get_shape("train_4k"))
    assert (shape.global_batch, shape.seq_len) == (16, 4096)


@pytest.mark.parametrize("tun", [DEFAULT_TUNABLES,
                                 Tunables(remat="none", microbatches=2,
                                          attn_impl="pallas")],
                         ids=["dots", "none_mb2_pallas"])
def test_card_cell_on_cpu_measures_the_fake_estimate(tun):
    """With ``device="cpu"`` the card's check runs a real step; its
    temporary bytes (``MemTracker`` over real tensors) equal the fake
    step's at the same shape."""
    cfg = reduced(get_config("qwen2-1.5b"))
    shape = ShapeSpec("t", 32, 4, "train")
    cell = D.CardCell(cfg, shape, device="cpu")
    try:
        rec = cell.run(tun)
    finally:
        cell.close()
    fake = D.step_temp(D._lower(cfg, shape, tun, OptConfig())[0])
    assert not rec["oom"] and rec["temp_source"] == "MemTracker"
    assert rec["temp_size_in_bytes"] == fake > 0
    assert rec["step_s"] > 0 and rec["state_bytes"] > 0


SMALL = ShapeSpec("t", 32, 4, "train")


@pytest.fixture
def callers_mesh():
    """A mesh the caller had set before the launch tooling ran."""
    mesh = ShapeMesh((2, 2), ("data", "model"))
    rules.set_mesh(mesh)
    yield mesh
    rules.set_mesh(None)


@pytest.mark.parametrize("remat,microbatches", [("none", 1), ("dots", 2),
                                                ("full", 2)])
def test_card_cell_steps_a_fitting_candidate_twice(monkeypatch,
                                                   callers_mesh, remat,
                                                   microbatches):
    """Two steps, each of microbatches x layers layer runs, twice under
    remat (forward and recompute): the count ``chip_smoke.py`` holds the
    flash launches to.  The host mesh is the rules' mesh while the cell
    is open, the caller's again after."""
    cfg = reduced(get_config("qwen2-1.5b"))
    entries = []
    real = T.block_apply
    monkeypatch.setattr(T, "block_apply",
                        lambda *a, **kw: entries.append(1) or real(*a, **kw))
    cell = D.CardCell(cfg, SMALL, device="cpu")
    try:
        assert rules.current_mesh() is cell.mesh
        rec = cell.run(Tunables(remat=remat, microbatches=microbatches))
    finally:
        cell.close()
    assert rules.current_mesh() is callers_mesh
    assert not rec["oom"] and rec["step_s"] > 0
    assert len(entries) == 2 * microbatches * cfg.n_layers * (
        1 + (remat != "none"))


@pytest.mark.parametrize("card", [False, True], ids=["16x16", "card_cpu"])
def test_hillclimb_keeps_the_callers_mesh(monkeypatch, tmp_path,
                                          callers_mesh, card):
    monkeypatch.setattr(H, "probe_cost", ns["probe_stub"])
    monkeypatch.setattr(H, "lower_cell", ns["lower_stub"])
    monkeypatch.setattr(H, "OUT_ROOT", tmp_path)
    monkeypatch.setattr(H, "get_config",
                        lambda name: reduced(get_config(name)))
    monkeypatch.setattr(H, "card_shape", lambda shape: SMALL)
    rec = H.hillclimb("qwen2-1.5b", "train_4k", card=card, device="cpu")
    assert rec["hillclimb"]["evaluations"] > 1
    assert rules.current_mesh() is callers_mesh
    if card:
        assert rec["step"]["temp_size_in_bytes"] > 0


def test_verify_budget_card_takes_the_winners_step(monkeypatch, tmp_path):
    """The hillclimb's winner (here recorded out of memory) is not stepped
    again: the walk's first real step is the next candidate's."""
    monkeypatch.setattr(H, "probe_cost", ns["probe_stub"])
    monkeypatch.setattr(VB, "get_config",
                        lambda name: reduced(get_config(name)))
    monkeypatch.setattr(VB, "card_shape", lambda shape: SMALL)
    monkeypatch.setattr(VB, "OUT_ROOT", tmp_path)
    stepped = []
    real = D.CardCell.run
    monkeypatch.setattr(D.CardCell, "run", lambda cell, tun: stepped.append(
        tun.remat) or real(cell, tun))
    trace = [{"tun": DEFAULT_TUNABLES.replace(remat=r).as_dict(),
              "est_s": e} for r, e in (("none", 1e-3), ("dots", 2e-3))]
    path = tmp_path / "1x1" / "qwen2-1.5b__train_4k__opt.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({
        "tunables": trace[0]["tun"],
        "step": {"oom": True, "state_bytes": 1, "temp_size_in_bytes": None},
        "hillclimb": {"baseline": trace[1], "trace": trace}}))
    rec = VB.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--card",
                   "--device", "cpu"])["hillclimb"]
    assert stepped == ["dots"]
    assert [t.get("oom", False) for t in rec["tried"]] == [True, False]
    assert rec["budgeted"]["tun"]["remat"] == "dots"
    assert rec["budgeted"]["step_s"] > 0
    assert rules.current_mesh() is None
