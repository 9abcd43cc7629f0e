"""§Perf hillclimb: KERMIT's Explorer searches the runtime-tunable space
with the dry run's roofline as the objective.

Port of ``repro/launch/hillclimb.py``: the paper's plug-in loop with
"measured job time" replaced by the cost model,

  est_step_time(tun) = max(compute_s, memory_s, collective_s)   [probes]

at the H100 SXM's constants (``analysis/roofline.py``).  The search trace
is the hypothesis -> change -> before/after log; the winner is checked and
stored as <arch>__<shape>__opt.json under ``dryrun.OUT_ROOT/<mesh>``.  Two
meshes:

* a production mesh, shape-only (16x16, or 2x16x16 with ``--multi-pod``):
  every estimate is the fake probes', and the winner's check is
  ``lower_cell`` (its temporary memory an estimate too);
* the card's (1, 1) mesh (``--card``; ``make_host_mesh``, CUDA unless
  ``--device cpu``): the same probes with no collectives, at the cell's
  shape per data shard of the 16x16 mesh (``dryrun.card_shape``:
  ``train_4k`` runs 16 rows of 4096), and the winner's check is one real
  train step on the card (``dryrun.CardCell``).

  python -m repro_torch.launch.hillclimb --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.hillclimb --arch qwen2-1.5b \\
      --shape train_4k --card --tun attn_impl=pallas

``--tun`` sets the starting tunables (``DEFAULT_TUNABLES`` without it, as
the reference starts).  Importing this module sets no environment
variable.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

from repro_torch.analysis.roofline import H100, model_flops, roofline_terms
from repro_torch.configs.base import DEFAULT_TUNABLES, SHAPES, Tunables
from repro_torch.configs.registry import ARCHS, get_config, get_shape
from repro_torch.core.explorer import DEFAULT_SPACE, Explorer
from repro_torch.kermit.executor import ExecutorObjective, MeasureCounters
from repro_torch.launch.dryrun import (OUT_ROOT, CardCell, _lower,
                                       card_shape, lower_cell, parse_tun,
                                       probe_cost)
from repro_torch.launch.mesh import make_host_mesh, make_shape_mesh
from repro_torch.optim.adamw import OptConfig

HBM_BUDGET = 80e9     # H100 SXM5 80 GB


def knob_space(cfg, kind: str) -> dict:
    """Shape/family-specific overrides layered over the one source of truth,
    ``core/explorer.DEFAULT_SPACE`` — candidate lists for shared knobs come
    from there, so the launcher's grid can't silently diverge from the
    on-line Plan phase's.  ``zero3``/``donate`` are launcher-only knobs."""
    if kind in ("decode",):
        space = {"zero3": [True, False], "donate": [True]}
        if cfg.moe is not None:
            # decode sweeps the capacity extremes, not the fine steps
            space["capacity_factor"] = [
                v for v in DEFAULT_SPACE["capacity_factor"] if v != 1.5]
        return space
    space = {
        "remat": list(DEFAULT_SPACE["remat"]),
        "microbatches": list(DEFAULT_SPACE["microbatches"]),
        "seq_parallel": list(DEFAULT_SPACE["seq_parallel"]),
        "zero3": [True, False],
    }
    if cfg.attn_free or cfg.family == "hybrid":
        space["ssm_chunk"] = list(DEFAULT_SPACE["ssm_chunk"])
    else:
        space["attn_q_chunk"] = list(DEFAULT_SPACE["attn_q_chunk"])
    if cfg.moe is not None:
        # training keeps the sub-2.0 capacity steps (2.0 OOMs the probes)
        space["capacity_factor"] = [
            v for v in DEFAULT_SPACE["capacity_factor"] if v <= 1.5]
    if kind == "prefill":
        space.pop("microbatches")
        space.pop("remat")
    return space


class RooflineExecutor(MeasureCounters):
    """Execute boundary for the dry-run hillclimb (the Plan phase's
    ``BatchExecutor`` protocol over fake-step probes).

    ``measure`` probes one candidate; ``measure_batch`` probes each
    candidate's raw cost terms and then reduces ``est = max(compute,
    memory, collective)`` across the whole batch in one vectorized pass
    over the stacked term matrix — the Explorer sweeps a knob per
    dispatch.  Trace rows and progress prints land in evaluation order as
    each probe completes.  Counter surface is the shared
    ``MeasureCounters`` shape.  ``chip`` sets the roofline's constants
    (the H100 SXM's).
    """

    def __init__(self, cfg, shape, oc, mesh, chips, mf, trace,
                 start: Tunables = DEFAULT_TUNABLES, chip=H100):
        self.cfg, self.shape, self.oc, self.mesh = cfg, shape, oc, mesh
        self.chips, self.mf, self.trace, self.chip = chips, mf, trace, chip
        self.current = start
        self._init_counters()

    def apply(self, tun: Tunables) -> None:
        self._count_apply(tun)

    def _probe_one(self, tun: Tunables):
        """Probe one candidate, append its trace row (error or est) in
        order, and return its term triple (+inf on failure so the commit
        scan skips it)."""
        t0 = time.time()
        try:
            cost, coll = probe_cost(self.cfg, self.shape, tun, self.oc,
                                    self.mesh)
        except Exception as e:
            self.trace.append({"tun": tun.as_dict(), "error": repr(e)})
            return (math.inf,) * 3
        rl = roofline_terms(cost, coll, chips=self.chips,
                            model_flops=self.mf, chip=self.chip)
        est = max(rl.compute_s, rl.memory_s, rl.collective_s)
        self.trace.append({"tun": tun.as_dict(), "est_s": est,
                           "compute_s": rl.compute_s,
                           "memory_s": rl.memory_s,
                           "collective_s": rl.collective_s,
                           "bottleneck": rl.bottleneck,
                           "eval_wall_s": round(time.time() - t0, 1)})
        print(f"  eval est={est:.3f}s bn={rl.bottleneck} "
              f"({json.dumps(tun.as_dict())})", flush=True)
        return (rl.compute_s, rl.memory_s, rl.collective_s)

    def measure(self) -> float:
        trial = self._trial()
        est = float(max(self._probe_one(self.current)))
        self._count_measure(trial)
        return est

    def measure_batch(self, candidates) -> list:
        candidates = list(candidates)
        trial = self._trial(len(candidates))
        # vectorized roofline reduction over the whole knob sweep
        terms = np.array([self._probe_one(c) for c in candidates],
                         np.float64).reshape(-1, 3)
        est = terms.max(axis=1)
        self._count_measure(trial, batch=True)
        return [float(e) for e in est]


def card_estimate(cfg, shape, tun, oc, mesh, mf) -> dict:
    """The roofline record of ``tun`` on the card's mesh, from the
    probes."""
    cost, coll = probe_cost(cfg, shape, tun, oc, mesh)
    return {"cost": cost, "collectives": coll,
            "roofline": roofline_terms(cost, coll, chips=1,
                                       model_flops=mf).as_dict()}


def hillclimb(arch: str, shape_name: str, *, multi_pod=False, card=False,
              device=None, start: Tunables = DEFAULT_TUNABLES):
    """Search ``knob_space`` from ``start`` and check the winner: on a
    shape-only production mesh, or with ``card`` on the (1, 1) mesh of
    ``device`` (None: CUDA, raising without a card)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if card:
        mesh = make_host_mesh(device)
        shape = card_shape(shape)
    else:
        mesh = make_shape_mesh(multi_pod=multi_pod)
    chips = mesh.size
    oc = OptConfig()

    _, n_total, n_active = _lower(cfg, shape, start, oc)
    mf = model_flops(cfg, shape, n_active)

    trace = []
    rex = RooflineExecutor(cfg, shape, oc, mesh, chips, mf, trace, start)
    objective = ExecutorObjective(rex)      # batched roofline probe sweeps

    ex = Explorer(knob_space(cfg, shape.kind), max_passes=2)
    print(f"[hillclimb] {arch} {shape_name}: baseline eval...", flush=True)
    res = ex.global_search(objective, start)
    base = trace[0]

    if card:
        print(f"[hillclimb] best est={res.cost:.3f}s after "
              f"{res.evaluations} evals; verifying with one step on "
              f"{mesh.device}...", flush=True)
        cell = CardCell(cfg, shape, oc, device=mesh.device)
        try:
            measured = cell.run(res.best)
        finally:
            cell.close()
        rec = {"arch": arch, "shape": shape_name, "mesh": "1x1",
               "chips": 1, "device": str(mesh.device),
               "tunables": res.best.as_dict(),
               "n_params_total": n_total, "n_params_active": n_active,
               "memory": {"temp_size_in_bytes":
                          measured["temp_size_in_bytes"],
                          "argument_size_in_bytes": measured["state_bytes"]},
               "step": measured,
               **card_estimate(cfg, shape, res.best, oc, mesh, mf),
               "reduced": {"global_batch": [get_shape(shape_name)
                                            .global_batch,
                                            shape.global_batch],
                           "why": "one card runs one data shard of the "
                                  "16x16 mesh"}}
        mesh_name = "1x1"
    else:
        print(f"[hillclimb] best est={res.cost:.3f}s after "
              f"{res.evaluations} evals; verifying with the full "
              f"estimate...", flush=True)
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod,
                         tun=res.best, oc=oc, verbose=False)
        mesh_name = "2x16x16" if multi_pod else "16x16"
    rec["hillclimb"] = {
        "baseline": base, "best": res.best.as_dict(),
        "best_est_s": res.cost, "evaluations": res.evaluations,
        "trace": trace,
    }
    out_dir = OUT_ROOT / mesh_name
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}__{shape_name}__opt.json"
    out.write_text(json.dumps(rec, indent=1))
    temp = rec["memory"].get("temp_size_in_bytes")
    temp = "oom" if temp is None else f"{temp / 1e9:.1f}GB"
    print(f"[hillclimb] {arch} {shape_name}: "
          f"{base['est_s']:.3f}s -> {res.cost:.3f}s "
          f"({base['est_s']/max(res.cost,1e-12):.2f}x), "
          f"temp={temp} (budget {HBM_BUDGET/1e9:.0f}GB), "
          f"evals={res.evaluations}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--card", action="store_true",
                    help="the card's (1, 1) mesh; the winner runs a step")
    ap.add_argument("--device", default=None,
                    help="with --card: torch device (default: cuda)")
    ap.add_argument("--tun", nargs="*", help="starting tunables k=v")
    args = ap.parse_args(argv)
    hillclimb(args.arch, args.shape, multi_pod=args.multi_pod,
              card=args.card, device=args.device, start=parse_tun(args.tun))


if __name__ == "__main__":
    main()
