"""Memory-budget post-pass for hillclimb results: walk the search trace in
ascending estimated-time order, check each candidate's memory, and keep the
fastest one whose per-device temporary memory fits the budget.  Writes the
result back into <arch>__<shape>__opt.json as "budgeted".

Port of ``repro/launch/verify_budget.py``, the same walk: the trace sorted
by ``est_s``, then seven synthetic memory-saving candidates, at most
``--max-tries`` of the trace.  As in the reference, only the temporary
bytes count against the budget, never the state (ROADMAP caveat 22).

* On a production mesh (shape-only) a candidate's memory is
  ``dryrun.lower_cell``'s estimate.
* On the card's (1, 1) mesh (``--card``; CUDA unless ``--device cpu``) it
  is one real train step of the candidate (``dryrun.CardCell``):
  ``torch.cuda.max_memory_allocated()`` above the state and the batch.  A
  candidate that runs out of memory has that as its measurement, "over
  budget" (``"oom": true``), and the walk goes on.  A candidate that fits
  runs a second step, timed, whose seconds stand beside its ``est_s``.
  The hillclimb's winner was stepped by ``hillclimb --card`` already: its
  record's ``step`` is that candidate's measurement here too.

  python -m repro_torch.launch.verify_budget --arch qwen2-1.5b \\
      --shape train_4k [--budget-gb 80] [--max-tries 6] [--card]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.analysis.roofline import model_flops
from repro_torch.configs.base import SHAPES, Tunables
from repro_torch.configs.registry import ARCHS, get_config, get_shape
from repro_torch.launch.dryrun import (OUT_ROOT, CardCell, _lower,
                                       card_shape, lower_cell)
from repro_torch.launch.hillclimb import card_estimate
from repro_torch.optim.adamw import OptConfig


class CardCheck:
    """The candidate check on the card: a real step of each candidate on
    a ``CardCell`` (``measured``: tunables -> a step the hillclimb already
    ran on the same cell); the roofline estimate from the probes where a
    candidate came with none (synthetic, or chosen)."""

    def __init__(self, arch, shape_name, device, measured):
        self.cfg = get_config(arch)
        self.shape = card_shape(get_shape(shape_name))
        self.oc = OptConfig()
        self.measured = measured
        self.cell = CardCell(self.cfg, self.shape, self.oc, device=device)
        _, _, n_active = _lower(self.cfg, self.shape, Tunables(), self.oc)
        self.mf = model_flops(self.cfg, self.shape, n_active)

    def estimate(self, tun) -> dict:
        return card_estimate(self.cfg, self.shape, tun, self.oc,
                             self.cell.mesh, self.mf)

    def __call__(self, tun, synthetic) -> dict:
        step = self.measured.get(_key(tun.as_dict())) or self.cell.run(tun)
        full = {"memory": {"temp_size_in_bytes": step["temp_size_in_bytes"],
                           "argument_size_in_bytes": step["state_bytes"]},
                "step": step}
        if synthetic:
            full.update(self.estimate(tun))
        return full


def _key(tun: dict) -> str:
    return json.dumps(tun, sort_keys=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--budget-gb", type=float, default=80.0)
    ap.add_argument("--max-tries", type=int, default=6)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--card", action="store_true",
                    help="the card's (1, 1) mesh: each candidate runs a step")
    ap.add_argument("--device", default=None,
                    help="with --card: torch device (default: cuda)")
    args = ap.parse_args(argv)

    mesh = "1x1" if args.card else "2x16x16" if args.multi_pod else "16x16"
    path = OUT_ROOT / mesh / f"{args.arch}__{args.shape}__opt.json"
    rec = json.loads(path.read_text())
    trace = [t for t in rec["hillclimb"]["trace"] if "est_s" in t]
    trace.sort(key=lambda t: t["est_s"])
    budget = args.budget_gb * 1e9

    # composite memory-saver candidates derived from the unconstrained best:
    # coordinate descent rarely revisits remat/microbatches after flipping
    # them early, but they are the main temp-memory levers.
    best_tun = dict(trace[0]["tun"])
    seen = {json.dumps(t["tun"], sort_keys=True) for t in trace}
    for extra in ({"remat": "dots"}, {"remat": "full"},
                  {"remat": "full", "microbatches": 8},
                  {"remat": "dots", "microbatches": 4},
                  {"zero3": True},
                  {"zero3": True, "remat": "dots"},
                  {"zero3": True, "remat": "full", "microbatches": 8}):
        cand = dict(best_tun, **extra)
        if json.dumps(cand, sort_keys=True) not in seen:
            trace.append({"tun": cand, "est_s": float("nan"),
                          "synthetic": True})

    card = None
    if args.card:
        card = CardCheck(args.arch, args.shape, args.device,
                         {_key(rec["tunables"]): rec["step"]}
                         if "step" in rec else {})
    if card is not None:
        check = card
    else:
        def check(tun, synthetic):
            return lower_cell(args.arch, args.shape,
                              multi_pod=args.multi_pod, tun=tun,
                              verbose=False)

    candidates = trace[:args.max_tries] + \
        [t for t in trace if t.get("synthetic")]
    chosen = None
    try:
        for t in candidates:
            tun = Tunables(**t["tun"])
            print(f"[verify] candidate est={t['est_s']:.3f}s "
                  f"{json.dumps(t['tun'])}", flush=True)
            full = check(tun, t.get("synthetic", False))
            if t.get("synthetic"):       # estimate came with the check
                r = full["roofline"]
                t["est_s"] = max(r["compute_s"], r["memory_s"],
                                 r["collective_s"])
            temp = full["memory"].get("temp_size_in_bytes")
            oom = temp is None and full.get("step", {}).get("oom", False)
            temp = temp or 0
            fits = not oom and temp <= budget
            shown = "oom" if oom else f"{temp/1e9:.1f}GB"
            print(f"[verify]   est={t['est_s']:.3f}s temp={shown} "
                  f"({'FITS' if fits else 'over budget'})", flush=True)
            t["temp_bytes"] = temp
            if oom:
                t["oom"] = True
            if fits:
                if card is not None and "roofline" not in full:
                    full.update(card.estimate(tun))
                chosen = (t, full)
                break
    finally:
        if card is not None:
            card.cell.close()
    if chosen is None:
        print("[verify] no candidate fit the budget; keeping unconstrained")
        rec["hillclimb"]["budgeted"] = None
    else:
        t, full = chosen
        rec["hillclimb"]["budgeted"] = {
            "tun": t["tun"], "est_s": t["est_s"],
            "temp_bytes": t["temp_bytes"],
            "roofline": full.get("roofline"), "memory": full["memory"],
        }
        if card is not None:
            step_s = full["step"]["step_s"]
            rec["hillclimb"]["budgeted"].update(
                step=full["step"], step_s=step_s,
                est_over_step=t["est_s"] / step_s)
            print(f"[verify] measured step {step_s:.3f}s against est "
                  f"{t['est_s']:.3f}s (est/step "
                  f"{t['est_s'] / step_s:.3f})", flush=True)
        base = rec["hillclimb"]["baseline"]["est_s"]
        print(f"[verify] budgeted optimum: {base:.3f}s -> {t['est_s']:.3f}s "
              f"({base/max(t['est_s'],1e-9):.2f}x) within "
              f"{args.budget_gb:.0f}GB", flush=True)
    rec["hillclimb"]["tried"] = [t for t in candidates if "temp_bytes" in t]
    path.write_text(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
