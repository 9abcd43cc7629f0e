"""Readings for a cell's limits: the program's and the control's, on many
seeds in one process (set-up once).

    python3 kbench/calibrate.py --workload qwen2-1.5b.code \\
        --seeds 11,12,13 --seconds 12 > readings.jsonl

For each seed: weights and prompts from the seed, a window of
``--seconds`` at the cell's own load, then the check with the control
beside it: per sampled request the widest gap of the served tokens
(``served``) and of the tokens the float8-weight reference ranks first
at the same positions (``control``), and the DBSCAN comparison; and
the verdict of the harness's own comparison on each, against the cell's
limits (``correct`` for the program, ``control_correct`` for the
control, which has to come out false).  A window this short may reach
no analysis, so these verdicts ask for no DBSCAN discovery; the labels
of any it reaches are compared all the same.  One JSON line per seed on
standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from kbench import harness, replay
    bench = harness.Bench(ROOT, args.workload, args.device)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        bench.prepare(seed, warm=(i == 0))
        out = bench.run(seed, args.seconds, False)
        rec = out["rec"]
        lat = out["latencies"]
        verdict = harness.correctness(bench, out, seed, control=True,
                                      min_discoveries=0)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "served_gap": max(verdict["gaps"]["served"], default=None),
            "control_gap": max(verdict["gaps"]["control"], default=None),
            "served": verdict["gaps"]["served"],
            "control": verdict["gaps"]["control"],
            "dbscan": verdict["dbscan"],
            "correct": verdict["correct"],
            "control_correct": verdict["control_correct"],
            "checks": verdict["checks"],
            "control_checks": verdict["control_checks"],
            "committed_windows": len(rec.windows),
            "committed_requests": len(lat),
            "p95_s": replay.p95_nearest_rank(lat) if len(lat) else None,
            "peak_bytes": int(out["peak"]),
            "seconds": time.perf_counter() - T_START}), flush=True)
        if bench.device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
