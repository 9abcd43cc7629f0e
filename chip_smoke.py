#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one card

Builds the hand-written CUDA kernel from ``src/repro_torch`` on first use
(nvcc, sm_90a), then runs, each phase printing one JSON line and any
failure raising (exit code != 0):

1. ``device``      — torch/CUDA versions; the card must be there.
2. ``kernel_nbr``  — the ε-neighbour kernel against its plain PyTorch
                     version on the card (N = 20 ... 16384, two ε): counts
                     and packed bits equal, except bits at pairs whose
                     float64 squared distance lies within 1e-6·ε² of ε²
                     (counted and printed); DBSCAN labels equal; times.
3. ``quickstart``  — ``examples/quickstart.py``'s config and schedule
                     through ``repro_torch`` on the card, with its asserts.
4. ``full_history``— the default config (analysis every 512 windows) over
                     4096 windows of 32 samples cycling the 7 simulator
                     archetypes: DBSCAN over the full 4096-window ring.

For the two main-path phases the kernel's launch counter is set to 0 just
before the run and read just after; each must equal the number of
analyses.  Every input the main path gave DBSCAN is then run through the
kernel and its plain version again and held to the same parity, and the
main path's labels to theirs.  Then one ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi reports them, and the final ``{"ok": true, ...}`` line.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import analyser as A  # noqa: E402
from repro_torch.core.dbscan import labels_from_adjacency  # noqa: E402
from repro_torch.core.simulator import (ARCHETYPES,  # noqa: E402
                                        archetype_stats)
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels import pairdist as P  # noqa: E402
from repro_torch.kermit import (AnalysisConfig, EventKind,  # noqa: E402
                                KermitConfig, KermitSession, MonitorConfig,
                                PlanConfig, SimulatorExecutor)

KERNEL_SRC = "src/repro_torch/kernels/csrc/nbr_adjacency.cu"
KERNEL_REPLACES = "src/repro/kernels/pairdist.py:117"
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
NEAR = 1e-6            # relative band around ε² where a bit may differ


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nbr_bound_ms(n: int, f: int, block: int = 128) -> tuple[float, str]:
    """Least time for the kernel's work on an H100: each input byte read
    once and each output byte written once, against 2F + 3 flops per pair
    of real points (the dot product, then sum, scale and difference);
    padded rows and columns need no arithmetic."""
    npad = n + (-n) % P.block_rows(n, block)
    bytes_ = n * f * 4 + npad * 4 + npad * (npad // 8)
    flops = n * n * (2 * f + 3)
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def time_ms(fn, reps: int, groups: int = 5) -> float:
    """Median over ``groups`` of the mean device time of ``reps``
    back-to-back calls (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def window_means(n: int, seed: int, window: int = 32):
    """(n, 16) simulator-like window means: the archetypes in turn, each
    window the mean of ``window`` noisy samples."""
    rng = np.random.default_rng(seed)
    stats = [archetype_stats(a) for a in ARCHETYPES]
    idx = np.arange(n) * len(stats) // max(n, 1)
    mean = np.stack([stats[i][0] for i in idx])
    std = np.stack([stats[i][1] for i in idx]) / np.sqrt(window)
    return (mean + rng.normal(size=mean.shape) * std).astype(np.float32)


def compare_kernel(x, eps: float, min_pts: int = 4, block: int = 128,
                   main_labels=None):
    """Kernel vs plain version on the card (made after the main-path
    phases have read the launch counter).  ``main_labels``: the labels the
    main path's DBSCAN returned for ``x``, held to both.  Returns the
    comparison record."""
    eps_sq = P._eps_sq(eps)
    c1, p1 = P._neighbor_adjacency_cuda(x, eps_sq=eps_sq, block=block)
    c2, p2 = P._neighbor_adjacency_plain(x, eps_sq=eps_sq, block=block)
    torch.cuda.synchronize()
    n = x.shape[0]
    npad = p1.shape[0]
    diff = p1 ^ p2
    rows = torch.nonzero(diff.any(dim=1)).flatten()
    near = 0
    if rows.numel():
        bits = P.unpack_bits(diff[rows]).nonzero()
        i, j = rows[bits[:, 0]], bits[:, 1]
        xp = torch.zeros((npad, x.shape[1]), dtype=torch.float64,
                         device=x.device)
        xp[:n] = x.double()
        d2 = ((xp[i] - xp[j]) ** 2).sum(1)
        ok = (d2 - eps * eps).abs() <= NEAR * eps * eps
        if not bool(ok.all()):
            raise AssertionError(
                f"kernel and plain disagree on {int((~ok).sum())} pairs away "
                f"from the ε threshold (N={n}, ε={eps})")
        near = int(i.numel())
    pop1 = P.unpack_bits(p1).sum(1, dtype=torch.int32)
    if not torch.equal(pop1, c1):
        raise AssertionError("kernel counts disagree with its packed bits")
    count_err = int((c1 - c2).abs().max())
    if near == 0 and (count_err or not torch.equal(p1, p2)):
        raise AssertionError(f"kernel differs from plain (N={n}, ε={eps})")
    l1 = labels_from_adjacency(c1, p1, n, min_pts, block)
    l2 = labels_from_adjacency(c2, p2, n, min_pts, block)
    if not np.array_equal(l1, l2):
        raise AssertionError(f"DBSCAN labels differ (N={n}, ε={eps})")
    if main_labels is not None and not np.array_equal(main_labels, l1):
        raise AssertionError(f"main-path labels differ (N={n}, ε={eps})")
    return {"n": n, "eps": eps, "near_threshold_bits": near,
            "max_abs_err": count_err, "clusters": int(l1.max() + 1),
            "noise": int((l1 < 0).sum())}


def time_kernel(x, eps: float, block: int = 128) -> dict:
    eps_sq = P._eps_sq(eps)
    n, f = x.shape
    reps = max(2, min(200, 2 * 10 ** 8 // max(n * n, 1)))
    ms = time_ms(lambda: P._neighbor_adjacency_cuda(x, eps_sq=eps_sq,
                                                    block=block), reps)
    plain = time_ms(lambda: P._neighbor_adjacency_plain(x, eps_sq=eps_sq,
                                                        block=block),
                    max(1, reps // 20), groups=3)
    bound, by = nbr_bound_ms(n, f, block)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by}


def phase_kernel(dev) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.load("nbr_adjacency")
    ptxas = [ln.strip() for ln in
             cuda_build.BUILD_LOGS.get("nbr_adjacency", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("kernel_build", seconds=time.perf_counter() - t0, ptxas=ptxas)
    for n in (20, 130, 257, 4096, 16384):
        x = torch.from_numpy(window_means(n, seed=n)).to(dev)
        for eps in (0.35, 0.3):
            rec = compare_kernel(x, eps)
            if n >= 4096 and eps == 0.35:
                rec.update(time_kernel(x, eps))
            emit("kernel_nbr", **rec)


@contextlib.contextmanager
def capture(owner, name: str, log: list, keep):
    """Temporarily wrap ``owner.name`` so each call appends
    ``keep(args, result)`` to ``log``."""
    real = getattr(owner, name)

    def run(*a, **kw):
        out = real(*a, **kw)
        log.append(keep(a, out))
        return out
    setattr(owner, name, run)
    try:
        yield
    finally:
        setattr(owner, name, real)


def dbscan_inputs(log: list):
    """Record (points, ε, min_pts, labels) of every DBSCAN call the
    analyser makes."""
    return capture(A, "dbscan", log, lambda a, out: (
        np.array(a[0], np.float32), float(a[1]), int(a[2]), out))


def check_main_path(phase: str, seen: list, dev) -> list:
    """Each input the main path gave the kernel, through kernel and plain
    version again: counts, bits and labels equal, and equal to the
    labels the main path got."""
    recs = []
    for x, eps, min_pts, labels in seen:
        rec = compare_kernel(torch.from_numpy(x).to(dev), eps, min_pts,
                             main_labels=labels)
        recs.append(rec)
    emit("main_path_parity", of=phase, inputs=len(recs),
         n=[r["n"] for r in recs],
         near_threshold_bits=sum(r["near_threshold_bits"] for r in recs),
         max_abs_err=max(r["max_abs_err"] for r in recs))
    return recs


QUICKSTART_CONFIG = KermitConfig(
    monitor=MonitorConfig(window_size=16),
    analysis=AnalysisConfig(interval=8, dbscan_eps=0.3),
    plan=PlanConfig(space={"microbatches": [1, 2, 4],
                           "remat": ["dots", "none"]}),
)
QUICKSTART_SCHEDULE = [("dense_train", 12), ("decode_serve", 12),
                       ("dense_train", 8)]


def phase_quickstart(dev):
    executor = SimulatorExecutor(QUICKSTART_SCHEDULE, window_size=16,
                                 seed=0, device=dev)
    retunes, seen = [], []
    with dbscan_inputs(seen), KermitSession(
            QUICKSTART_CONFIG, executor=executor, device=dev) as session:
        session.subscribe(EventKind.RETUNE, retunes.append)
        P.LAUNCHES = 0
        t0 = time.perf_counter()
        tunables = session.run()
        seconds = time.perf_counter() - t0
        launches = P.LAUNCHES
        summary = session.summary()
        analyses = sum(e.kind == "analysis" for e in session.events)
    assert summary["known_workloads"] >= 2, summary
    assert retunes, "the plan phase should have retuned at least once"
    assert (tunables.microbatches, tunables.remat) == (2, "none"), tunables
    if dev.type == "cuda":
        assert launches == analyses == len(seen) > 0, (launches, analyses)
    emit("quickstart", seconds=seconds, windows=summary["windows"],
         known_workloads=summary["known_workloads"],
         anticipated_hybrids=summary["anticipated_hybrids"],
         analyses=analyses, kernel_launches=launches,
         retunes=[(e.window_id, e.tunables["microbatches"],
                   e.tunables["remat"]) for e in retunes],
         plugin=summary["plugin"])
    return launches, check_main_path("quickstart", seen, dev)


def device_profile(fn) -> dict:
    """Run ``fn`` once under torch.profiler: wall seconds (profiler on),
    device-busy seconds (sum of CUDA kernel durations, one stream) and the
    kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0))
            by_name[e.name] = (n + 1, t + us)
    busy = sum(t for _, t in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": (1 - busy / wall) if busy else None,
            "launches": sum(n for n, _ in by_name.values()),
            "top": [(name[:60], n, t / 1e3) for name, (n, t) in top]}


def phase_full_history(dev, n_windows: int = 4096, interval: int = 512):
    config = KermitConfig(analysis=AnalysisConfig(interval=interval),
                          monitor=MonitorConfig(retention=n_windows))
    n_seg = -(-n_windows // 66) + 1
    schedule = [(ARCHETYPES[i % len(ARCHETYPES)], 64) for i in range(n_seg)]
    executor = SimulatorExecutor(schedule, window_size=32, seed=0,
                                 device=dev)
    samples = executor.samples[:n_windows * 32]
    cuda = dev.type == "cuda"

    session = KermitSession(config, executor=executor, device=dev)
    seen, reports = [], []
    with dbscan_inputs(seen), capture(session.analyser, "run", reports,
                                      lambda a, out: out):
        P.LAUNCHES = 0
        t0 = time.perf_counter()
        tunables = session.run(samples)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = P.LAUNCHES
    summary = session.summary()
    analyses = sum(e.kind == "analysis" for e in session.events)
    retunes = [e for e in session.events if e.kind == "retune"]
    assert summary["windows"] == n_windows, summary
    assert analyses == n_windows // interval == len(reports), analyses
    if cuda:
        assert launches == analyses == len(seen), (launches, analyses)
    assert reports[-1].n_windows == n_windows
    # dense_train and ssm_train sit 0.21 apart in the 16-feature space,
    # inside ε = 0.35: with a full history DBSCAN joins them, as the
    # reference does, so 6 of the 7 archetypes are told apart
    assert summary["known_workloads"] >= len(ARCHETYPES) - 1, summary
    assert retunes, "the plan phase should have retuned"
    assert (tunables.microbatches, tunables.remat,
            tunables.attn_q_chunk) == (2, "none", 1024), tunables

    x_last, _, _, labels_last = seen[-1]

    # monitor throughput with the trained models, on a fresh monitor
    mon = type(session.monitor)(window_size=32,
                                detector=session.monitor.detector,
                                classifier=session.analyser.classifier,
                                predictor=session.analyser.predictor,
                                retention=n_windows, device=dev)
    mon.ingest_array(samples[:32 * 128])            # warm
    t1 = time.perf_counter()
    ctx = mon.ingest_array(samples)
    mon_s = time.perf_counter() - t1
    known = sum(c.current_label >= 0 for c in ctx)
    emit("full_history", seconds=seconds, windows=n_windows,
         analyses=analyses, kernel_launches=launches,
         dbscan_points_last=int(x_last.shape[0]),
         clusters_last=int(labels_last.max() + 1),
         discover_s=[r.discover_seconds for r in reports],
         train_s=[r.train_seconds for r in reports],
         dbscan_s=[r.dbscan_seconds for r in reports],
         forest_fit_s=[r.forest_seconds for r in reports],
         lstm_fit_s=[r.predictor_seconds for r in reports],
         monitor_windows_per_s=n_windows / mon_s,
         monitor_labelled_frac=known / len(ctx),
         known_workloads=summary["known_workloads"],
         anticipated_hybrids=summary["anticipated_hybrids"],
         retunes=len(retunes), plugin=summary["plugin"])

    if cuda:
        # where the device time goes: one more analysis over the full ring
        # and one monitor pass, each under the profiler (after the counted
        # run; the profiler's own overhead is in the wall times)
        ws = session.monitor.window_series(copy=True)
        emit("profile", what="analysis", **device_profile(
            lambda: session.analyser.run(ws)))
        emit("profile", what="monitor", **device_profile(
            lambda: mon.ingest_array(samples)))
    mon.close()
    session.close()
    return launches, check_main_path("full_history", seen, dev), x_last


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)

    phase_kernel(dev)
    quick_launches, quick = phase_quickstart(dev)
    full_launches, full, x_last = phase_full_history(dev)
    main = quick + full
    # timed at the main path's largest input: the last analysis, over the
    # full ring
    x_main = torch.from_numpy(x_last).to(dev)
    main_shape = time_kernel(x_main, 0.35)
    eps_sq = P._eps_sq(0.35)
    prof = device_profile(lambda: [P._neighbor_adjacency_cuda(
        x_main, eps_sq=eps_sq, block=128) for _ in range(20)])
    kern = [t / n for name, n, t in prof["top"] if "nbr_adjacency" in name]
    device_ms = kern[0] if kern else None        # per launch the profiler saw
    emit("profile", what="nbr_adjacency x20", **prof)
    print(json.dumps({"kernels": [{
        "name": "nbr_adjacency", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES,
        "launches": quick_launches + full_launches,
        "launches_by_phase": {"quickstart": quick_launches,
                              "full_history": full_launches},
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "n": int(x_main.shape[0]), "device_ms": device_ms,
        "parity": {"main_path_inputs": len(main),
                   "n": sorted({r["n"] for r in main}),
                   "near_threshold_bits": sum(r["near_threshold_bits"]
                                              for r in main)},
        "tolerance": "counts and bits equal; a bit may differ only where "
                     "the float64 squared distance is within 1e-6·ε² of ε²; "
                     "labels equal"}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
