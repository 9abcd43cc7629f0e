"""The benchmark of ``repro_torch``: one run of one cell.

    python3 kbench/run.py --workload qwen2-1.5b.code --seed 7 \\
        --seconds 51 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (with device traces of a few committed serve calls).
The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
with ``--trace 1``), then ``checks``, each number compared with its
limit; the same numbers end standard error.  Exits non-zero, printing no
result, without enough CUDA devices, when JAX or the JAX package was
loaded, or when the program is missing.  Caches of builds stay inside
the checkout (``kbench/.cache``; the program's kernels build into
``src/repro_torch/kernels/build``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "kbench" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process, few threads: no OpenMP pool spinning beside the thread
    # that launches the kernels
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print(f"needs {chips[args.workload]} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from kbench import harness
    result = harness.measure(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
