#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one card

Builds the hand-written CUDA kernels from ``src/repro_torch`` on first use
(one nvcc per source, started together, sm_90a; ptxas's registers and
spills per instantiation and the HGMMA/HMMA count of each kernel's SASS,
or the wgmma/mma.sync count of its PTX without cuobjdump), then runs, each phase printing JSON lines and any failure
raising (exit code != 0):

1. ``device``        — torch/CUDA versions; the card must be there.
2. ``kernel_nbr``    — the ε-neighbour kernel against its plain PyTorch
                       version (N = 20 ... 16384, two ε): counts and packed
                       bits equal, except bits at pairs whose float64
                       squared distance lies within 1e-6·ε² of ε² (counted
                       and printed); DBSCAN labels equal; event and device
                       times at N = 24, 4096 and 16384.
3. ``kernel_flash``  — the GQA flash-attention kernel against its plain
                       version: the reference's sweep in fp32 (CUDA-core
                       kernel) and bf16 (wgmma kernel), qwen2-1.5b's
                       serving and long shapes, a gemma2 case, zamba2-7b's
                       shared block (d = 112); times and device times
                       beside SDPA's and the bound.
4. ``kernel_ssd``    — the SSD chunked-scan kernel against its plain
                       version: the reference's sweep in fp32 (CUDA-core
                       kernel) and bf16 (mma.sync kernel), mamba2-1.3b's
                       serving shapes, S = 2048 and 8192 in chunks of 256,
                       a zamba2-7b shape; times and device times beside the
                       tensor-core and fp32 bounds.
5. ``kernel_pairdist`` — the dense pairwise-distance kernel against its
                       plain version: the reference's sweep and window
                       means at N = 20 ... 16384 (N ≡ 0, 1, 2, 3 mod 4
                       at 1952–1955), every entry within
                       1e-5·(|x_i|² + |x_j|²) + 1e-6; its ε-threshold
                       equal to the ε-neighbour kernel's bits (N <= 4096);
                       event and device times, back to back and with L2
                       flushed, beside
                       ``torch.cdist``'s and the bound.
6. ``quickstart``    — ``examples/quickstart.py``'s config and schedule
                       through ``repro_torch`` on the card, with its asserts.
7. ``full_history``  — the default config (analysis every 512 windows) over
                       4096 windows of 32 samples cycling the 7 simulator
                       archetypes: DBSCAN over the full 4096-window ring.
8. ``quickstart_legacy`` — the quickstart on the seed path
                       (``impl="legacy"``): the dense kernel once per
                       analysis, the ε-neighbour kernel never; the
                       quickstart's asserts and its RETUNE stream.
9. ``legacy_history`` — the first 2048 windows of ``full_history``'s
                       stream on the seed path (retention 4096, analysis
                       every 512 windows): the last analysis's DBSCAN
                       over the full ring, profiled.
10. ``serving``      — KERMIT tuning a live qwen2-1.5b server at full width
                       (bf16, random weights from seed 0) with
                       ``attn_impl="pallas"``: diurnal night -> day traffic
                       through ``KermitSession`` + ``ServeExecutor``, with
                       the asserts of ``tests/test_serving_autonomic.py``.
11. ``serving_parity``— prefill logits on the pallas route against the xla
                       route: reduced qwen2 in fp32 (asserted at 1e-4), and
                       the full model in bf16 (printed); a profiled call.
12. ``serving_ssm``, ``serving_ssm_parity`` — the same loop, checks and
                       profile on mamba2-1.3b (chunks of 16).
13. ``hybrid``       — zamba2-7b at full width behind ``ServeEngine``: a
                       few serve calls through both kernels, and a profiled
                       call.
14. ``training``     — KERMIT tuning a live qwen2-1.5b training job at full
                       width (bf16, random weights from seed 0): ``Trainer``
                       + ``KermitSession`` with examples/autonomic_train.py's
                       session and phase a's shape (B = 8, S = 128),
                       ``attn_impl="pallas"``, 48 steps (ANALYSIS at window
                       10, the search at 11); step times, the search's
                       trials, peak memory per remat policy, a profiled
                       train step.
15. ``training_parity`` — one train step on the pallas and the xla route
                       from the same weights and batch (loss, grad norm,
                       every gradient leaf); the Functions' input grads
                       (kernel forward) against autograd through the plain
                       versions at the training shapes, fp32 and bf16.
16. ``training_ssm`` — mamba2-1.3b at full width (bf16), phase b's shape
                       (B = 4, S = 256, chunks of 256), int8 AdamW moments,
                       6 steps, no session.
17. ``fault_tolerance`` — examples/fault_tolerance.py's run: checkpoints
                       every 5 steps, failures at 8 and 17, against an
                       uninterrupted run.
18. ``scenarios``    — the manifest's nine ported scenarios (the session,
                       crash, serving and fleet kinds) at seeds 0 and 1
                       through ``repro_torch.scenarios`` on the card: every
                       gate true, per-scenario seconds; the two scenarios
                       of unported kinds printed with the ROADMAP item each
                       waits for.
19. ``durable_history`` — full_history's config and stream under
                       ``KermitSupervisor`` (a snapshot every 512 windows),
                       uninterrupted and with a ``CrashFault`` at window
                       2600: decisions (events, RETUNE tunables, monitor
                       labels, final tunables) equal, one crash and one
                       restore; the snapshot's bytes and one checkpoint's
                       and one restore's seconds at retention 4096.
20. ``plan_model``   — ``benchmarks/bench_costmodel.py``'s two gates on the
                       card: the model-guided Plan commits the oracle's
                       cost within 10 % of the 5184-point grid (seeds 0–2),
                       and ``model_guided=False`` is bit-identical to the
                       unmodelled Plan.
21. ``fleet_ingest`` — ``benchmarks/bench_fleet.py``'s throughput scenario:
                       ``KermitFleet`` with 256 tenants (retention 4096,
                       windows of 16 samples cycling four archetypes, 32
                       nominal windows per tenant, the forest and LSTM
                       trained on the card in every monitor, no analysis)
                       against 256 isolated ``KermitSession``s, one
                       ``step_batch`` per window: labels, transition flags
                       and predictions equal per tenant and window;
                       windows/s of both; a steady tick profiled at S = 8
                       and S = 256 (equal launches), its syncs and copies.
22. ``fleet_parity`` — ``bench_fleet.py``'s parity-and-transfer run: 8
                       tenants with simulator executors and cross-tenant
                       transfer against 8 isolated sessions: labels,
                       transition windows, committed winners and stored
                       configurations equal; warm starts and saved
                       evaluations at least 1; the reference's counts
                       printed beside.
23. ``clustering``   — ``benchmarks/bench_clustering.py`` (Fig. 10):
                       DBSCAN, kmeans at k and k + 2 and single-link over
                       six seeded window series; Awt and purity.

For each main-path phase every kernel's launch counter is set to 0 just
before the run and read just after: the ε-neighbour kernel must have run
once per analysis of the fast paths, the dense kernel once per analysis
of the seed paths (and the ε-neighbour kernel never there, the dense
kernel never on the fast paths; in ``scenarios``, ``durable_history``
and ``fleet_parity`` once per analysis run, replays, reruns and isolated
sessions included; in ``clustering`` once per DBSCAN and single-link; in
``fleet_ingest`` never), the attention
kernel once per attention layer of every prefill (28 × serve calls for
qwen2, 13 per zamba2 prefill), the SSD kernel once per SSD layer of
every prefill (48 × serve calls for mamba2, 81 per zamba2 prefill), and
in training once per layer run: each forward
pass and each remat recompute of a layer (counted, as they start), every
one of those bf16 launches on the
tensor-core kernels (the per-dtype counters).  The backward of both is a
recompute through their plain versions (``attention_xla``,
``ssd_chunked``) differentiated by autograd, as the reference's
``custom_vjp``s are; it launches no kernel.  The inputs the main path gave each kernel are
then run through the kernel and its plain version again and held to the
same parity.  Then one ``{"kernels": [...]}`` line, the card's name and
power limit as nvidia-smi reports them, and the final ``{"ok": true, ...}``
line.  On the seed paths every recorded DBSCAN input is also held to the
fast path: its legacy labels equal ``dbscan(impl="auto")``'s on the card.
Every ``profile`` line prints, per kernel of the repo, the launches its
trace shows beside the launches its wrapper counted over the same run
(``launches_seen``, ``launches_expected``) and whether spin kernels
around the profiled work show the trace's losses to be a prefix that
ended before it (``loss_is_a_prefix``).  A kernel missing from a trace
fails the run, and so does a per-call device time from a trace that
fails either check; a profile line from such a trace prints its busy
time and idle share as bounds.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.base import (DEFAULT_TUNABLES,  # noqa: E402
                                      ShapeSpec, Tunables, reduced)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import analyser as A  # noqa: E402
from repro_torch.core.dbscan import (  # noqa: E402
    agglomerative_single_link, dbscan, kmeans, labels_from_adjacency)
from repro_torch.core.simulator import (ARCHETYPES,  # noqa: E402
                                        archetype_stats)
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import pairdist as P  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kermit import (AnalysisConfig, EventKind,  # noqa: E402
                                FleetConfig, KermitConfig, KermitFleet,
                                KermitSession, KnowledgeConfig,
                                MonitorConfig, PlanConfig, ServeConfig,
                                ServeEngine, ServeExecutor, SimulatorExecutor,
                                TrafficGenerator, run_serving_session)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm_lm as SLM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import OptConfig, tree_leaves  # noqa: E402
from repro_torch.runtime.fault import FailureInjector  # noqa: E402
from repro_torch.runtime.loop import Trainer  # noqa: E402
from repro_torch.train.step import (loss_and_grads,  # noqa: E402
                                    make_train_step)
from repro_torch.core.explorer import DEFAULT_SPACE, Explorer  # noqa: E402
from repro_torch.core.knowledge import WorkloadDB  # noqa: E402
from repro_torch.core.monitor import WorkloadContext  # noqa: E402
from repro_torch.core.plugin import KermitPlugin  # noqa: E402
from repro_torch.kermit import (ChaosExecutor, CrashFault,  # noqa: E402
                                ExecConfig, KermitSupervisor)
from repro_torch.scenarios import (UNPORTED_KINDS,  # noqa: E402
                                   load_manifest, run_manifest)
from repro_torch.runtime.checkpoint import load_snapshot  # noqa: E402
from repro_torch.core.simulator import generate, random_schedule  # noqa: E402
from repro_torch.core.windows import make_windows  # noqa: E402

KERNEL_SRC = "src/repro_torch/kernels/csrc/nbr_adjacency.cu"
KERNEL_REPLACES = "src/repro/kernels/pairdist.py:117"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:34"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:30"
DENSE_SRC = "src/repro_torch/kernels/csrc/pairdist.cu"
DENSE_REPLACES = "src/repro/kernels/pairdist.py:55"
# |kernel − plain| <= DENSE_RTOL·(|x_i|² + |x_j|²) + DENSE_ATOL: the two sum
# in different orders, and fp32 cancellation scales with the norms
DENSE_RTOL = 1e-5
DENSE_ATOL = 1e-6
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, dense bf16 in them, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
NEAR = 1e-6            # relative band around ε² where a bit may differ


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nbr_bound_ms(n: int, f: int, block: int = 128) -> tuple[float, str]:
    """Least time for the kernel's work on an H100: each input byte read
    once and each output byte written once, against 2F + 3 flops per
    unordered pair of real points, itself included (the dot product, then
    sum, scale and difference): d2(i, j) and d2(j, i) are one float, so
    n(n + 1)/2 evaluations decide every bit.  Padded rows and columns need
    no arithmetic."""
    npad = n + (-n) % P.block_rows(n, block)
    bytes_ = n * f * 4 + npad * 4 + npad * (npad // 8)
    flops = n * (n + 1) // 2 * (2 * f + 3)
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
    """Event time of back-to-back calls, the device time of one call (the
    kernel and the memset that zeroes the counts), the plain version's
    time and the bound."""
    eps_sq = P._eps_sq(eps)
    n, f = x.shape
    reps = max(2, min(200, 2 * 10 ** 8 // max(n * n, 1)))

    def kernel():
        return P._neighbor_adjacency_cuda(x, eps_sq=eps_sq, block=block)
    ms = time_ms(kernel, reps)
    device = device_ms_per_call(kernel, f"nbr_adjacency N={n} x20",
                                ("nbr_adjacency_kernel", "Memset"))
    plain = time_ms(lambda: P._neighbor_adjacency_plain(x, eps_sq=eps_sq,
                                                        block=block),
                    max(1, reps // 20), groups=3)
    bound, by = nbr_bound_ms(n, f, block)
    return {"n": n, "ms": ms, "device_ms": device, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by}


def short_name(mangled: str) -> str:
    """``flash_fwd_wgmma<128>`` from its mangled name (enough to tell the
    instantiations apart)."""
    for kernel in ("flash_fwd_wgmma", "flash_fwd_kernel", "ssd_fwd_mma",
                   "ssd_fwd_kernel", "nbr_adjacency", "pairdist"):
        if kernel in mangled:
            args = mangled.split(kernel, 1)[1]
            return kernel + "<" + ",".join(
                a for a in args.replace("E", " ").replace("Li", " ")
                .replace("Lb", " ").split() if a.isdigit()) + ">"
    return mangled


SASS_MIX = ("FFMA", "FADD", "FMUL", "FSET", "FSETP", "SEL", "LOP3", "LDS",
            "STS", "STG", "REDG", "SHFL")


def phase_build() -> None:
    """Build the four kernels, one nvcc each, started together; print
    ptxas's registers, shared memory and spills per instantiation, and
    the tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync) in each
    kernel's SASS, or their PTX names where the toolkit has no cuobjdump;
    a bf16 kernel without them fails the phase.  Also the static SASS
    instruction mix of the two CUDA-core pair kernels (``SASS_MIX``)."""
    t0 = time.perf_counter()
    cuda_build.build("nbr_adjacency", "flash_attention", "ssd_scan",
                     "pairdist")
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, log in cuda_build.BUILD_LOGS.items():
        rows, fn = {}, None
        for ln in log.splitlines():
            if "Function properties for" in ln:
                fn = short_name(ln.split("for", 1)[1].strip())
            elif fn and ("registers" in ln or "spill" in ln):
                rows.setdefault(fn, []).append(ln.replace(
                    "ptxas info    :", "").strip())
        ptxas[name] = {k: "; ".join(v) for k, v in rows.items()}
    # the tensor-core instructions of each bf16 kernel: HGMMA (wgmma) and
    # HMMA (mma.sync) in its SASS, or, without cuobjdump, their PTX names
    found, seen_in = {}, {}
    for name, kernel, op, ptx_op in (
            ("flash_attention", "flash_fwd_wgmma", "HGMMA", "wgmma.mma_async"),
            ("ssd_scan", "ssd_fwd_mma", "HMMA", "mma.sync")):
        counts, key, seen_in[name] = cuda_build.sass_counts(name), op, "sass"
        if counts is None:
            counts, key, seen_in[name] = (cuda_build.ptx_counts(name), ptx_op,
                                          "ptx")
        found[name] = {short_name(k): v for k, v in counts.items()}
        got = [v[key] for k, v in found[name].items() if kernel in k]
        assert got and min(got) > 0, (name, key, found[name])
    # the CUDA-core pair kernels' instruction mix (static SASS counts per
    # instantiation, "all" every instruction; None without cuobjdump)
    mix = {name: cuda_build.sass_counts(name, SASS_MIX)
           for name in ("nbr_adjacency", "pairdist")}
    emit("kernel_build", seconds=seconds, ptxas=ptxas, tensor_core=found,
         tensor_core_seen_in=seen_in, sass_mix={
             name: None if m is None else {short_name(k): v
                                           for k, v in m.items()}
             for name, m in mix.items()})


# window means (F = 16) held to the plain version; ε = 0.35 timed at
# serving's largest analysis (N = 24) and at N = 4096 and 16384
NBR_NS = (20, 24, 130, 257, 4096, 16384)
NBR_TIMED = (24, 4096, 16384)


def phase_kernel(dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    timed = {}
    for n in NBR_NS:
        x = torch.from_numpy(window_means(n, seed=n)).to(dev)
        for eps in (0.35, 0.3):
            rec = compare_kernel(x, eps)
            if n in NBR_TIMED and eps == 0.35:
                rec.update(time_kernel(x, eps))
                timed[n] = rec
            emit("kernel_nbr", **rec)
    return timed


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
        P.LAUNCHES = P.DENSE_LAUNCHES = 0
        t0 = time.perf_counter()
        tunables = session.run()
        seconds = time.perf_counter() - t0
        launches, dense = P.LAUNCHES, P.DENSE_LAUNCHES
        summary = session.summary()
        analyses = sum(e.kind == "analysis" for e in session.events)
        events = event_stream(session.events)
    assert summary["known_workloads"] >= 2, summary
    assert retunes, "the plan phase should have retuned at least once"
    assert (tunables.microbatches, tunables.remat) == (2, "none"), tunables
    if dev.type == "cuda":
        assert launches == analyses == len(seen) > 0, (launches, analyses)
        assert dense == 0, dense
    emit("quickstart", seconds=seconds, windows=summary["windows"],
         known_workloads=summary["known_workloads"],
         anticipated_hybrids=summary["anticipated_hybrids"],
         analyses=analyses, kernel_launches=launches,
         retunes=[(e.window_id, e.tunables["microbatches"],
                   e.tunables["remat"]) for e in retunes],
         plugin=summary["plugin"])
    return launches, check_main_path("quickstart", seen, dev), events


def event_stream(events) -> list:
    """(window, kind, label, tunables as (microbatches, remat) or None,
    detail without wall seconds) for every event."""
    return [(e.window_id, str(e.kind), e.label,
             None if e.tunables is None else (e.tunables["microbatches"],
                                              e.tunables["remat"]),
             {k: v for k, v in e.detail.items() if k != "seconds"})
            for e in events]


# a wrapper's launch counter (per design for flash and SSD) -> a substring
# of its kernel's name in a trace
TRACE_NAMES = {"nbr_adjacency": "nbr_adjacency_kernel",
               "pairdist": "pairdist_kernel",
               "flash_attention/bfloat16": "flash_fwd_wgmma",
               "flash_attention/float32": "flash_fwd_kernel",
               "ssd_scan/bfloat16": "ssd_fwd_mma",
               "ssd_scan/float32": "ssd_fwd_kernel"}
# seconds of idle the profiler's steps put around ``fn``: after the warm-up
# step's op and after ``fn``
PROFILER_PAD_S = 0.05
# the recorded step's idle before ``fn``, one per attempt: a trace that is
# not complete is taken again with the next, longer lead
PROFILE_LEADS_S = (0.05, 0.5, 2.0)
# spin kernels (torch.cuda._sleep, cycles below; left out of every count
# and sum) around the recorded window's device work: a long one that holds
# the stream while the host queues the rest, so they run back to back;
# LEAD_SENTINELS short ones; a marker, the last before ``fn``; and one
# after ``fn``.  Told apart by their lengths.
SPIN_HOLD, SPIN_LEAD, SPIN_MARK, SPIN_CLOSE = 10_000_000, 20_000, 200_000, \
    1_000_000
LEAD_SENTINELS = 64


def classify_spins(spans: list) -> dict:
    """The spin kernels of one trace, ``spans`` as (start, end) in us.
    The shortest seen is a short opening one (at least two must be seen);
    the others are classified by their length over it.  The trace's losses
    are shown to be a prefix of the window, ended before ``fn``, when the
    spins seen read, in order of start, [hold], lead x k (k >= 2), marker,
    closing, and no lead between the first seen and the marker is missing:
    each starts within half a lead's length of the end of the one before."""
    spans = sorted(spans)
    unit = min((e - b for b, e in spans), default=0.0)

    def kind(b, e):
        r = (e - b) / unit
        return ("lead" if r < 3 else "marker" if r < 25 else
                "closing" if r < 100 else "hold")
    kinds = [kind(b, e) for b, e in spans] if unit > 0 else []
    if kinds[:1] == ["hold"]:
        kinds, spans = kinds[1:], spans[1:]
    leads = kinds.count("lead")
    gaps = [spans[i + 1][0] - spans[i][1] for i in range(len(spans) - 2)]
    prefix = (kinds == ["lead"] * leads + ["marker", "closing"]
              and leads >= 2 and max(gaps) < unit / 2)
    return {"sentinels_seen": leads, "marker_seen": "marker" in kinds,
            "closing_seen": kinds[-1:] == ["closing"],
            "sentinel_gap_us_max": max(gaps, default=None),
            "loss_is_a_prefix": bool(prefix)}


def wrapper_launches() -> dict:
    """The wrappers' launch counters, keyed as ``TRACE_NAMES``."""
    c = counters()
    out = {"nbr_adjacency": c["nbr_adjacency"], "pairdist": c["pairdist"]}
    for name in ("flash_attention", "ssd_scan"):
        out.update({f"{name}/{dt}": n
                    for dt, n in c["by_dtype"][name].items()})
    return out


def device_profile(fn, per_kernel: dict | None = None) -> dict:
    """Run ``fn`` under torch.profiler: wall seconds (profiler on),
    device-busy seconds (sum of device event durations, one stream; the
    profiler's step annotations left out), the kernels that took most of
    it, and the host seconds spent reading the trace afterwards;
    ``per_kernel`` receives every device event name's (launches, ms).

    ``fn`` runs in the profiler's second step, after a warm-up step, with
    idle and spin kernels (``classify_spins``; left out of the counts)
    before and after it inside the recorded step: on the H100 machine,
    traces lost their first device records (16 of 20 ε-neighbour and 11
    of 20 dense launches seen when ``fn`` began the trace; later in a long
    run, the first records even after 50 ms of idle).  A trace is complete
    when its spins show that any loss was a prefix that ended before the
    marker, the closing spin is there, and the launches of each repo
    kernel that it shows (``launches_seen``) equal its wrapper's counter
    over the same run (``launches_expected``).  When it is not, ``fn``
    runs again after a longer lead (``PROFILE_LEADS_S``); the last trace's
    busy time and idle share are printed as measured when it is complete
    and as ``device_busy_s_lower_bound`` and ``idle_share_upper_bound``
    when it is not.  A kernel the wrappers launched that is absent from
    that trace fails the phase."""
    for attempt, lead in enumerate(PROFILE_LEADS_S, 1):
        rec, by_name = _profile_once(fn, lead)
        if rec["trace_complete"]:
            break
    absent = [k for k, n in rec["launches_expected"].items()
              if n and not rec["launches_seen"][k]]
    if absent:
        trace = sorted((n, k[:50]) for k, (n, _) in by_name.items())
        raise AssertionError(f"launched but absent from the trace: {absent} "
                             f"({rec['launches_expected']} expected, "
                             f"{rec['launches_seen']} seen; the trace: "
                             f"{trace})")
    if per_kernel is not None:
        per_kernel.update({name: (n, t / 1e3)
                           for name, (n, t) in by_name.items()})
    return {**rec, "attempts": attempt}


def _profile_once(fn, lead: float) -> tuple[dict, dict]:
    """One recorded run of ``fn`` after ``lead`` seconds of idle (see
    ``device_profile``)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
        prof.step()
        time.sleep(lead)
        torch.cuda._sleep(SPIN_HOLD)
        for _ in range(LEAD_SENTINELS):
            torch.cuda._sleep(SPIN_LEAD)
        torch.cuda._sleep(SPIN_MARK)
        torch.cuda.synchronize()
        before = wrapper_launches()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = wrapper_launches()
        torch.cuda._sleep(SPIN_CLOSE)
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
        t1 = time.perf_counter()
        prof.step()                        # ends the recorded step
    by_name: dict = {}
    spins = []
    for e in prof.events():
        if "spin_kernel" in e.name:
            spins.append((e.time_range.start, e.time_range.end))
        elif (e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("ProfilerStep")):
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0))
            by_name[e.name] = (n + 1, t + us)
    expected = {k: after[k] - before[k] for k in TRACE_NAMES}
    seen = {k: sum(n for name, (n, _) in by_name.items() if sub in name)
            for k, sub in TRACE_NAMES.items()}
    keys = [k for k in TRACE_NAMES if expected[k] or seen[k]]
    sentinels = classify_spins(spins)
    complete = (sentinels["loss_is_a_prefix"]
                and all(seen[k] == expected[k] for k in keys))
    busy = sum(t for _, t in by_name.values()) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    tag = "" if complete else "_lower_bound"
    return {"wall_s": wall, f"device_busy_s{tag}": busy,
            "trace_processing_s": time.perf_counter() - t1,
            ("idle_share" if complete else "idle_share_upper_bound"):
                (1 - busy / wall) if busy else None,
            "trace_complete": complete,
            "launches_seen": {k: seen[k] for k in keys},
            "launches_expected": {k: expected[k] for k in keys},
            "launches": sum(n for n, _ in by_name.values()),
            **sentinels, "lead_s": lead,
            "top": [(name[:60], n, t / 1e3) for name, (n, t) in ranked[:6]]
            }, by_name


def device_ms_per_call(fn, what: str, names=None, calls: int = 20) -> float:
    """Device time of one call of ``fn`` over ``calls`` back-to-back calls
    under the profiler (its line printed as ``what``): the summed durations
    of every device event whose name holds one of ``names`` — every kernel
    (and memset) one call of the C entry launches — or, with ``names``
    None, of every device event, over the calls.  Raises when the trace
    stays incomplete or shows no launch of ``names[0]``."""
    per: dict = {}

    def run():
        for _ in range(calls):
            fn()
    prof = device_profile(run, per)
    emit("profile", what=what, calls=calls, **prof)
    if not prof["trace_complete"]:
        raise AssertionError(f"the trace of {what} stayed incomplete after "
                             f"{prof['attempts']} attempts")
    if names is None:
        return sum(t for _, t in per.values()) / calls
    if not any(names[0] in name for name in per):
        raise AssertionError(f"{names[0]} absent from the trace of {what}")
    return sum(t for name, (_, t) in per.items()
               if any(s in name for s in names)) / calls


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
        P.LAUNCHES = P.DENSE_LAUNCHES = 0
        t0 = time.perf_counter()
        tunables = session.run(samples)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, dense = P.LAUNCHES, P.DENSE_LAUNCHES
    summary = session.summary()
    analyses = sum(e.kind == "analysis" for e in session.events)
    retunes = [e for e in session.events if e.kind == "retune"]
    assert summary["windows"] == n_windows, summary
    assert analyses == n_windows // interval == len(reports), analyses
    if cuda:
        assert launches == analyses == len(seen), (launches, analyses)
        assert dense == 0, dense
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
    outcome = {"known_workloads": summary["known_workloads"],
               "retunes": [(e.window_id, e.tunables["microbatches"],
                            e.tunables["remat"], e.tunables["attn_q_chunk"])
                           for e in retunes],
               "final": (tunables.microbatches, tunables.remat,
                         tunables.attn_q_chunk)}
    return (launches, check_main_path("full_history", seen, dev), x_last,
            outcome)


# ---------------------------------------------------------------------------
# dense pairdist and the seed (legacy) paths
# ---------------------------------------------------------------------------

# the reference's sweep (tests/test_kernels.py:14-16): N, F, dtype, block 64
DENSE_SWEEP = [(64, 8, torch.float32), (200, 16, torch.float32),
               (130, 4, torch.bfloat16)]
# window means (F = 16); the threshold is checked up to 4096, the last two
# are timed (and the main path's N = 1955 after legacy_history)
DENSE_NS = (20, 130, 257, 1952, 1953, 1954, 1955, 4096, 16384)


def dense_bound_ms(n: int, f: int, elem: int = 4) -> tuple[float, str]:
    """Least time for the dense kernel's work on an H100: x read once and
    the (N, N) fp32 matrix written once, against 2F + 3 flops per entry
    (the dot product, then sum, scale and difference)."""
    bytes_ = n * f * elem + n * n * 4
    flops = n * n * (2 * f + 3)
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def compare_dense(x, block: int = 128):
    """Dense kernel vs plain version on the same input; raises past the
    tolerance.  Returns (the kernel's matrix, max abs difference, max
    difference over its tolerance)."""
    got = P._pairdist_cuda(x)
    want = P._pairdist_plain(x, block=block)
    torch.cuda.synchronize()
    n = x.shape[0]
    if got.shape != (n, n) or not bool((got >= 0).all()):
        raise AssertionError(f"dense kernel: bad output {tuple(got.shape)}")
    sq = (x.double() ** 2).sum(1)
    err = ratio = 0.0
    for r0 in range(0, n, 2048):                   # bounded temporaries
        e = (got[r0:r0 + 2048].double() - want[r0:r0 + 2048].double()).abs()
        tol = DENSE_RTOL * (sq[r0:r0 + 2048, None] + sq[None, :]) + \
            DENSE_ATOL
        if not bool((e <= tol).all()):
            raise AssertionError(
                f"dense kernel differs from plain past the tolerance "
                f"(N={n}, F={x.shape[1]}, {x.dtype}): {float(e.max())}")
        err = max(err, float(e.max()))
        ratio = max(ratio, float((e / tol).max()))
    return got, err, ratio


def threshold_matches_nbr(x, d2, eps: float) -> int:
    """``d2 <= ε²`` against the ε-neighbour kernel's unpacked bits on the
    same points: must be equal bit for bit.  Returns the adjacency's
    number of set bits."""
    n = x.shape[0]
    eps_sq = P._eps_sq(eps)
    counts, packed = P._neighbor_adjacency_cuda(x.float(), eps_sq=eps_sq,
                                                block=128)
    adj = P.unpack_bits(packed[:n], n)
    if not torch.equal(d2 <= eps_sq, adj):
        raise AssertionError(
            f"dense threshold differs from the ε-neighbour bits at "
            f"{int(((d2 <= eps_sq) ^ adj).sum())} pairs (N={n}, ε={eps})")
    return int(counts[:n].sum())


# written between launches for the L2-flushed times: more than the
# H100's 50 MB L2, so each launch finds the cache full of other dirty lines
L2_FLUSH_BYTES = 128 << 20


def time_dense(x) -> dict:
    """The dense kernel: event time of back-to-back calls, device time
    back to back and with a 128 MiB buffer written before each launch
    (``device_ms_l2_flushed``: the output cannot stay in L2 between
    launches); the plain version's time, ``torch.cdist(x, x).square()``'s
    event and device time, and the bound.  The bound share is read from
    the flushed time."""
    n, f = x.shape
    reps = max(5, min(200, 2 * 10 ** 8 // max(n * n, 1)))
    bound, by = dense_bound_ms(n, f, x.element_size())
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=x.device)

    def kernel():
        return P._pairdist_cuda(x)

    def flushed():
        flush.zero_()
        return kernel()

    def library():
        return torch.cdist(x, x).square()
    return {"ms": time_ms(kernel, reps),
            "device_ms": device_ms_per_call(kernel, f"pairdist N={n} x20",
                                            ("pairdist_kernel",)),
            "device_ms_l2_flushed": device_ms_per_call(
                flushed, f"pairdist N={n}, L2 flushed x20",
                ("pairdist_kernel",)),
            "plain_ms": time_ms(lambda: P._pairdist_plain(x),
                                max(1, reps // 5), groups=3),
            "library_ms": time_ms(library, reps),
            "library_device_ms": device_ms_per_call(
                library, f"torch.cdist N={n} x20"),
            "bound_ms": bound, "bound_by": by}


def phase_kernel_pairdist(dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    errs, timed = [], {}
    for n, f, dtype in DENSE_SWEEP:
        x = torch.from_numpy(np.random.default_rng(n).normal(
            size=(n, f)).astype(np.float32)).to(dev, dtype)
        d2, err, ratio = compare_dense(x, block=64)
        bits = {eps: threshold_matches_nbr(x, d2, eps) for eps in (0.35, 0.3)}
        errs.append(err)
        emit("kernel_pairdist", n=n, f=f, dtype=str(dtype), block=64,
             max_abs_err=err, max_err_over_tol=ratio, adjacency_bits=bits)
    for n in DENSE_NS:
        x = torch.from_numpy(window_means(n, seed=n)).to(dev)
        d2, err, ratio = compare_dense(x)
        rec = {"n": n, "f": 16, "max_abs_err": err,
               "max_err_over_tol": ratio}
        if n <= 4096:
            rec["adjacency_bits"] = {eps: threshold_matches_nbr(x, d2, eps)
                                     for eps in (0.35, 0.3)}
        del d2
        if n >= DENSE_NS[-2]:
            rec.update(time_dense(x))
            timed[n] = rec
        errs.append(err)
        emit("kernel_pairdist", **rec)
    timed["max_abs_err"] = max(errs)
    return timed


def check_dense_main_path(phase: str, seen: list, dev) -> list:
    """Each DBSCAN input of a seed-path run, on the card: the dense kernel
    against its plain version, its threshold against the ε-neighbour
    kernel's bits, and the run's legacy labels against the fast path's."""
    recs = []
    for x, eps, min_pts, labels in seen:
        xt = torch.from_numpy(x).to(dev)
        d2, err, ratio = compare_dense(xt)
        threshold_matches_nbr(xt, d2, eps)
        fast = dbscan(xt, eps, min_pts, device=dev)
        if not np.array_equal(labels, fast):
            raise AssertionError(f"legacy labels differ from the fast path's "
                                 f"(N={x.shape[0]}, ε={eps})")
        recs.append({"n": int(x.shape[0]), "max_abs_err": err,
                     "max_err_over_tol": ratio,
                     "clusters": int(labels.max() + 1)})
    emit("main_path_parity", of=phase, kernel="pairdist", inputs=len(recs),
         n=[r["n"] for r in recs],
         max_abs_err=max(r["max_abs_err"] for r in recs),
         max_err_over_tol=max(r["max_err_over_tol"] for r in recs),
         legacy_labels_equal_fast=True)
    return recs


def phase_quickstart_legacy(dev, fast_events: list):
    """The quickstart on the seed path: the dense kernel once per analysis,
    the ε-neighbour kernel never, the quickstart's asserts, and the fast
    run's RETUNE stream."""
    executor = SimulatorExecutor(QUICKSTART_SCHEDULE, window_size=16,
                                 seed=0, device=dev)
    config = dataclasses.replace(QUICKSTART_CONFIG, impl="legacy")
    seen = []
    with dbscan_inputs(seen), KermitSession(
            config, executor=executor, device=dev) as session:
        P.LAUNCHES = P.DENSE_LAUNCHES = 0
        t0 = time.perf_counter()
        tunables = session.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        nbr, dense = P.LAUNCHES, P.DENSE_LAUNCHES
        summary = session.summary()
        events = event_stream(session.events)
    analyses = sum(e[1] == "analysis" for e in events)
    retunes = [e for e in events if e[1] == "retune"]
    emit("quickstart_legacy", seconds=seconds, windows=summary["windows"],
         known_workloads=summary["known_workloads"],
         anticipated_hybrids=summary["anticipated_hybrids"],
         analyses=analyses, kernel_launches={"pairdist": dense,
                                             "nbr_adjacency": nbr},
         final=(tunables.microbatches, tunables.remat),
         events=events, quickstart_events=fast_events,
         plugin=summary["plugin"])
    assert summary["known_workloads"] >= 2, summary
    assert retunes, "the plan phase should have retuned at least once"
    assert (tunables.microbatches, tunables.remat) == (2, "none"), tunables
    assert dense == analyses == len(seen) > 0, (dense, analyses)
    assert nbr == 0, nbr
    assert retunes == [e for e in fast_events if e[1] == "retune"], retunes
    return dense, check_dense_main_path("quickstart_legacy", seen, dev)


def phase_legacy_history(dev, full: dict, n_windows: int = 2048,
                         interval: int = 512):
    """The first ``n_windows`` of ``full_history``'s stream through the
    seed path (retention 4096, an analysis every ``interval`` windows):
    the last analysis's DBSCAN runs the dense kernel over the full ring.
    Half of ``full_history``'s windows: the seed LSTM loop (30 epochs over
    every batch) took the phase past 90 s at 4096."""
    config = KermitConfig(analysis=AnalysisConfig(interval=interval),
                          monitor=MonitorConfig(retention=4096),
                          impl="legacy")
    n_seg = -(-4096 // 66) + 1                  # full_history's schedule
    schedule = [(ARCHETYPES[i % len(ARCHETYPES)], 64) for i in range(n_seg)]
    executor = SimulatorExecutor(schedule, window_size=32, seed=0,
                                 device=dev)
    samples = executor.samples[:n_windows * 32]
    session = KermitSession(config, executor=executor, device=dev)
    seen, reports = [], []
    with dbscan_inputs(seen), capture(session.analyser, "run", reports,
                                      lambda a, out: out):
        P.LAUNCHES = P.DENSE_LAUNCHES = 0
        t0 = time.perf_counter()
        tunables = session.run(samples)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        nbr, dense = P.LAUNCHES, P.DENSE_LAUNCHES
    summary = session.summary()
    analyses = sum(e.kind == "analysis" for e in session.events)
    retunes = [e for e in session.events if e.kind == "retune"]
    assert summary["windows"] == n_windows, summary
    assert analyses == n_windows // interval == len(reports), analyses
    assert dense == analyses == len(seen), (dense, analyses)
    assert nbr == 0, nbr
    assert reports[-1].n_windows == n_windows

    # monitor throughput with the trained models, on a fresh seed monitor
    mon = type(session.monitor)(window_size=32,
                                detector=session.monitor.detector,
                                classifier=session.analyser.classifier,
                                predictor=session.analyser.predictor,
                                retention=n_windows, fast=False, device=dev)
    mon.ingest_array(samples[:32 * 16])             # warm
    part = samples[:32 * 512]
    t1 = time.perf_counter()
    ctx = mon.ingest_array(part)
    mon_s = time.perf_counter() - t1
    mon.close()
    x_last, eps, min_pts, labels_last = seen[-1]
    emit("legacy_history", seconds=seconds, windows=n_windows,
         interval=interval, analyses=analyses,
         kernel_launches={"pairdist": dense, "nbr_adjacency": nbr},
         dbscan_points=[int(r[0].shape[0]) for r in seen],
         clusters_last=int(labels_last.max() + 1),
         discover_s=[r.discover_seconds for r in reports],
         train_s=[r.train_seconds for r in reports],
         dbscan_s=[r.dbscan_seconds for r in reports],
         forest_fit_s=[r.forest_seconds for r in reports],
         lstm_fit_s=[r.predictor_seconds for r in reports],
         monitor_windows_per_s=len(ctx) / mon_s,
         known_workloads=summary["known_workloads"],
         anticipated_hybrids=summary["anticipated_hybrids"],
         retunes=[(e.window_id, e.tunables["microbatches"],
                   e.tunables["remat"], e.tunables["attn_q_chunk"])
                  for e in retunes],
         final=(tunables.microbatches, tunables.remat,
                tunables.attn_q_chunk),
         full_history=full, plugin=summary["plugin"])
    assert summary["known_workloads"] >= 2, summary
    session.close()
    recs = check_dense_main_path("legacy_history", seen, dev)

    # where the device time of the seed DBSCAN goes: the last analysis's
    # input once more under the profiler (after the counted run)
    emit("profile", what="legacy dbscan (last analysis)", **device_profile(
        lambda: dbscan(x_last, eps, min_pts, impl="legacy", device=dev)))
    return dense, recs, x_last


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# B, Sq, Skv, H, K, d, causal, window, softcap (tests/test_kernels.py)
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 8, 1, 32, True, 64, 50.0),
    (2, 64, 128, 4, 4, 64, False, 0, 0.0),
    (1, 96, 96, 2, 2, 128, True, 0, 30.0),
]
# Sq > Skv under a sliding window: query rows 111 and later see no key,
# and average v over the KV as the reference pads it
EMPTY_ROWS_CASE = (1, 200, 96, 4, 2, 32, True, 16, 0.0)
QWEN2 = dict(H=12, K=2, d=128)            # qwen2-1.5b's attention heads
ZAMBA2_ATTN = dict(H=32, K=32, d=112)     # zamba2-7b's shared block
MAIN_SHAPE = (8, 48)                       # (B, S): a day-phase prefill
# the serving path's prefills: serve_batch in {2, 4, 8}, prompts of 16
# (night) and 48 (day) tokens; then two long prompts
QWEN2_SHAPES = ((2, 16), (2, 48), (4, 16), (4, 48), (8, 16), (8, 48),
                (1, 2048), (1, 8192))


def flash_tol(dtype) -> tuple[float, float]:
    """(atol, rtol) for |kernel − plain| <= atol + rtol·|plain|.  fp32: the
    reference's 2e-5.  bf16 outputs: the tensor-core kernel's products are
    exact (bf16 in, fp32 sums) and its P enters as hi + lo bf16 (~2^-17
    of p), so kernel and plain differ by their sum order and the final
    rounding, at most one bf16 step, 2^-7 of a value; atol 1e-3 covers
    values near 0."""
    return (2e-5, 2e-5) if dtype == torch.float32 else (1e-3, 2 ** -7)


def attn_inputs(dev, B, Sq, Skv, H, K, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in ((B, Sq, H, d), (B, Skv, K, d), (B, Skv, K, d)))


def compare_flash(q, k, v, *, causal=True, window=0, softcap=0.0,
                  bk=128) -> float:
    """Kernel vs plain version on the same inputs; raises past the
    tolerance, returns the max abs difference."""
    got = FA._flash_fwd_cuda(q, k, v, causal=causal, window=window,
                             softcap=softcap, bk=bk)
    want = FA._flash_fwd_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap, bk=bk)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    atol, rtol = flash_tol(q.dtype)
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"flash kernel differs from plain by {err} "
                             f"({tuple(q.shape)}, {q.dtype})")
    return err


def flash_bound(B, S, H, K, d, elem=2) -> dict:
    """Least time for causal attention at (B, S): each of q, k, v and out
    read or written once; 4·d flops per visible (query, key) pair and
    head, S(S+1)/2 visible pairs per sequence."""
    bytes_ = elem * B * S * d * (2 * H + 2 * K)
    flops = 4 * d * H * B * S * (S + 1) / 2
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_fp32_ms": max(t_bytes, flops / PEAK_FP32_FLOPS) * 1e3,
            "flops": flops, "bytes": bytes_}


def time_flash(dev, B, S, heads=QWEN2) -> dict:
    q, k, v = attn_inputs(dev, B, S, S, dtype=torch.bfloat16, seed=S, **heads)
    reps = max(3, min(200, int(2e9 / (S * S * B))))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        return FA._flash_fwd_cuda(q, k, v)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    rec = {"B": B, "S": S,
           "ms": time_ms(kernel, reps),
           "plain_ms": time_ms(lambda: FA._flash_fwd_plain(q, k, v),
                               max(1, reps // 20), groups=3),
           "library_ms": time_ms(library, reps),
           "device_ms": device_ms_per_call(
               kernel, f"flash_attention B={B} S={S} d={heads['d']} x20",
               ("flash_fwd",)),
           "library_device_ms": device_ms_per_call(
               library, f"sdpa B={B} S={S} d={heads['d']} x20")}
    rec.update(flash_bound(B, S, **heads))
    return rec


def phase_kernel_flash(dev) -> dict:
    for case in ATTN_CASES + [EMPTY_ROWS_CASE]:
        B, Sq, Skv, H, K, d, causal, win, cap = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(dev, B, Sq, Skv, H, K, d, dtype)
            emit("kernel_flash", case=list(case), dtype=str(dtype),
                 max_abs_err=compare_flash(q, k, v, causal=causal,
                                           window=win, softcap=cap))
    q, k, v = attn_inputs(dev, 1, 512, 512, 16, 8, 224, torch.bfloat16)
    emit("kernel_flash", case="gemma2-9b heads (H=16, K=8, d=224, "
         "window 64, softcap 50)", S=512, dtype="bf16",
         max_abs_err=compare_flash(q, k, v, window=64, softcap=50.0))
    timed = {}
    for B, S in QWEN2_SHAPES:
        q, k, v = attn_inputs(dev, B, S, S, dtype=torch.bfloat16, seed=1,
                              **QWEN2)
        rec = time_flash(dev, B, S)
        rec["max_abs_err"] = compare_flash(q, k, v)
        if S >= 2048:
            # long rows in fp32 too, where the tolerance is 2e-5
            q, k, v = attn_inputs(dev, B, S, S, dtype=torch.float32, seed=2,
                                  **QWEN2)
            rec["max_abs_err_fp32"] = compare_flash(q, k, v)
        emit("kernel_flash", case="qwen2-1.5b", dtype="bf16", **rec)
        timed[(B, S)] = rec
    # zamba2-7b's shared attention block at its serving prefill
    B, S = MAIN_SHAPE
    rec = time_flash(dev, B, S, ZAMBA2_ATTN)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attn_inputs(dev, B, S, S, dtype=dtype, seed=3,
                              **ZAMBA2_ATTN)
        rec[f"max_abs_err_{str(dtype)[6:]}"] = compare_flash(q, k, v)
    emit("kernel_flash", case="zamba2-7b", dtype="bf16", **rec)
    timed["zamba2"] = rec
    return timed


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

# B, S, H, P, G, N, chunk (tests/test_kernels.py:80-84), each in fp32 and
# bf16, and a chunk that leaves a partial 32-row tile
SSD_CASES = [(2, 128, 4, 16, 1, 32, 32), (1, 256, 8, 32, 2, 16, 64),
             (1, 64, 2, 8, 1, 8, 16), (1, 96, 4, 32, 2, 24, 48)]
MAMBA2 = dict(H=64, P=64, G=1, N=128)      # mamba2-1.3b's SSD heads
ZAMBA2 = dict(H=112, P=64, G=1, N=64)      # zamba2-7b's
SSD_CHUNK = 16                             # the serving path's ssm_chunk
# the serving path's prefills (serve_batch in {2, 4, 8}, prompts of 16 and
# 48 tokens, chunks of 16), then two long prompts in chunks of 256
SSD_SHAPES = ((2, 16, 16), (2, 48, 16), (4, 16, 16), (4, 48, 16),
              (8, 16, 16), (8, 48, 16), (1, 2048, 256), (1, 8192, 256))


# (atol, rtol) for |kernel − plain| <= atol + rtol·|plain|, y and state
# alike: the reference's own bound between its kernel and ``ssd_chunked``
# in fp32.  bf16 inputs are held to it too: the tensor-core kernel's
# products of x, B, C are exact, and its three fp32 operands enter as
# hi + lo bf16 pairs (~2^-17 of a value), while the plain version computes
# in fp32.
SSD_TOL = (1e-4, 1e-4)


def ssd_inputs(dev, B, S, H, P, G, N, dtype, seed=0):
    """The reference sweep's distributions: x normal, dt = softplus(normal),
    A = −exp(0.3·normal), B and C 0.3·normal."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = normal(B, S, H, P).to(dtype)
    dt = F.softplus(normal(B, S, H))
    A = -torch.exp(normal(H) * 0.3)
    Bm = (normal(B, S, G, N) * 0.3).to(dtype)
    Cm = (normal(B, S, G, N) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


def compare_ssd(x, dt, A, Bm, Cm, *, chunk) -> float:
    """Kernel vs plain version on the same inputs; raises past the
    tolerance, returns the max abs difference over y and the state."""
    y, s = SSD._ssd_fwd_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    wy, ws = SSD._ssd_fwd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    err = max(float((y - wy).abs().max()), float((s - ws).abs().max()))
    atol, rtol = SSD_TOL
    if not (torch.allclose(y, wy, rtol=rtol, atol=atol)
            and torch.allclose(s, ws, rtol=rtol, atol=atol)):
        raise AssertionError(f"SSD kernel differs from plain by {err} "
                             f"({tuple(x.shape)}, N={Bm.shape[-1]}, "
                             f"chunk={chunk}, {x.dtype})")
    return err


def ssd_bound(B, S, H, P, G, N, Q, elem=2) -> dict:
    """Least time for the scan on an H100: x, B, C (``elem`` bytes) and dt
    read once, y and the state (fp32) written once; per chunk 2·Q²·N
    flops per group for C·Bᵀ, Q(Q+1)/2·(2P + 3) per head for the masked
    scores times x, 4·Q·N·P per head for the state read and update.
    ``bound_ms`` against the bf16 tensor-core peak (the hi + lo split's
    extra products not counted), ``bound_fp32_ms`` against the fp32
    CUDA-core peak."""
    nc = S // Q
    flops = B * nc * (G * 2 * Q * Q * N
                      + H * (Q * (Q + 1) / 2 * (2 * P + 3) + 4 * Q * N * P))
    bytes_ = (elem * (B * S * H * P + 2 * B * S * G * N) + 4 * B * S * H
              + 4 * H + 4 * B * S * H * P + 4 * B * H * N * P)
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    t_fp32 = flops / PEAK_FP32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_fp32_ms": max(t_bytes, t_fp32) * 1e3,
            "bound_fp32_by": "bytes" if t_bytes > t_fp32 else "operations",
            "flops": flops, "bytes": bytes_}


def time_ssd(dev, B, S, Q, widths) -> dict:
    args = ssd_inputs(dev, B, S, dtype=torch.bfloat16, seed=S, **widths)
    reps = max(3, min(200, int(4e6 / (B * S * Q))))
    rec = {"B": B, "S": S, "chunk": Q,
           "grid": dict(zip(("heads_per_block", "p_columns_per_block"),
                            SSD.mma_grid(B, S, widths["H"], widths["P"],
                                         widths["G"], widths["N"], Q))),
           "ms": time_ms(lambda: SSD._ssd_fwd_cuda(*args, chunk=Q), reps),
           "plain_ms": time_ms(lambda: SSD._ssd_fwd_plain(*args, chunk=Q),
                               max(1, reps // 20), groups=3),
           "device_ms": device_ms_per_call(
               lambda: SSD._ssd_fwd_cuda(*args, chunk=Q),
               f"ssd_scan B={B} S={S} chunk={Q} H={widths['H']} x20",
               ("ssd_fwd",)),
           "library_ms": None, "library_device_ms": None}
    H, P = widths["H"], widths["P"]
    R, PS = rec["grid"].values()
    rec["grid"]["blocks"] = B * (H // R) * (P // PS)
    rec.update(ssd_bound(B, S, Q=Q, **widths))
    return rec


def phase_kernel_ssd(dev) -> dict:
    for case in SSD_CASES:
        B, S, H, P, G, N, chunk = case
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(dev, B, S, H, P, G, N, dtype)
            emit("kernel_ssd", case=list(case), dtype=str(dtype),
                 max_abs_err=compare_ssd(*args, chunk=chunk))
    timed = {}
    for name, widths, shapes in (("mamba2-1.3b", MAMBA2, SSD_SHAPES),
                                 ("zamba2-7b", ZAMBA2, ((8, 48, 16),))):
        for B, S, Q in shapes:
            rec = time_ssd(dev, B, S, Q, widths)
            for dtype in (torch.bfloat16, torch.float32):
                args = ssd_inputs(dev, B, S, dtype=dtype, seed=1, **widths)
                rec[f"max_abs_err_{str(dtype)[6:]}"] = compare_ssd(
                    *args, chunk=Q)
            emit("kernel_ssd", case=name, dtype="bf16", **widths, **rec)
            timed[(name, B, S)] = rec
    return timed


# ---------------------------------------------------------------------------
# serving: KERMIT tuning a live qwen2-1.5b server
# ---------------------------------------------------------------------------

SERVE_INITIAL = Tunables(attn_impl="pallas", serve_batch=8, cache_len=64)
SERVE_SPACE = {"serve_batch": [2, 4, 8], "cache_len": [64]}
# mamba2: chunks of 16, so every 48-token day prefill carries its state
# across 3 chunks; the chunk stays fixed, so the search is slice 2's
SSM_INITIAL = Tunables(attn_impl="pallas", serve_batch=8, cache_len=64,
                       ssm_chunk=SSD_CHUNK)
SSM_SPACE = {"serve_batch": [2, 4, 8], "ssm_chunk": [SSD_CHUNK]}
HYBRID_TUN = Tunables(attn_impl="pallas", cache_len=64, ssm_chunk=SSD_CHUNK)

def summary(rec: dict) -> dict:
    """The numbers of one timed shape that the kernels line carries."""
    return {k: rec.get(k) for k in ("ms", "device_ms", "device_ms_l2_flushed",
                                     "library_ms",
                                     "library_device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "grid")
            if k in rec}


def by_dtype(*runs: dict, name: str) -> dict:
    """Launches of kernel ``name`` per dtype over main-path runs."""
    return {dt: sum(r["by_dtype"][name][dt] for r in runs)
            for dt in ("bfloat16", "float32")}


def serve_config(initial: Tunables, space: dict) -> KermitConfig:
    """The session config of tests/test_serving_autonomic.py:179-184."""
    return KermitConfig(
        monitor=MonitorConfig(window_size=8),
        analysis=AnalysisConfig(interval=6, min_windows=6),
        knowledge=KnowledgeConfig(drift_eps=0.45),
        plan=PlanConfig(space=space, default_tunables=initial.as_dict()))


def flash_key(a, kw) -> tuple:
    q, k = a[0], a[1]
    return (tuple(q.shape), tuple(k.shape), q.dtype,
            tuple(sorted(kw.items())))


def ssd_key(a, kw) -> tuple:
    return (tuple(a[0].shape), tuple(a[3].shape), a[0].dtype, kw["chunk"])


# kernel name -> (module, wrapper, key of a launch's inputs, comparison)
KERNELS = {
    "flash_attention": (FA, "_flash_fwd_cuda", flash_key,
                        lambda a, kw: compare_flash(*a[:3], **kw)),
    "ssd_scan": (SSD, "_ssd_fwd_cuda", ssd_key,
                 lambda a, kw: compare_ssd(*a, **kw)),
}


@contextlib.contextmanager
def launch_inputs(name: str, first: dict, last: collections.deque, n: int):
    """Record the (args, kwargs) of the first ``n`` launches of kernel
    ``name`` for every distinct (shape, dtype, options) — one prefill's
    layers — and of the last ``last.maxlen`` launches: references only,
    detached (the path makes new inputs for every layer and does not
    modify them)."""
    module, attr, key, _ = KERNELS[name]
    real = getattr(module, attr)

    def run(*a, **kw):
        # detached: a training step's inputs would hold its autograd graph
        rec = (tuple(t.detach() if isinstance(t, torch.Tensor) else t
                     for t in a), kw)
        recs = first.setdefault(key(a, kw), [])
        if len(recs) < n:
            recs.append(rec)
        last.append(rec)
        return real(*a, **kw)
    setattr(module, attr, run)
    try:
        yield
    finally:
        setattr(module, attr, real)


def reset_counters() -> None:
    P.LAUNCHES = P.DENSE_LAUNCHES = FA.LAUNCHES = SSD.LAUNCHES = 0
    FA.LAUNCHES_BY_DTYPE = dict.fromkeys(FA.LAUNCHES_BY_DTYPE, 0)
    SSD.LAUNCHES_BY_DTYPE = dict.fromkeys(SSD.LAUNCHES_BY_DTYPE, 0)


def counters() -> dict:
    return {"nbr_adjacency": P.LAUNCHES, "flash_attention": FA.LAUNCHES,
            "ssd_scan": SSD.LAUNCHES, "pairdist": P.DENSE_LAUNCHES,
            "by_dtype": {"flash_attention": dict(FA.LAUNCHES_BY_DTYPE),
                         "ssd_scan": dict(SSD.LAUNCHES_BY_DTYPE)}}


def assert_tensor_core_route(launches: dict) -> None:
    """Every launch of flash and SSD in a bf16 main-path run took the
    tensor-core kernel (the bf16 instantiation)."""
    for name in ("flash_attention", "ssd_scan"):
        by = launches["by_dtype"][name]
        assert by["bfloat16"] == launches[name] and by["float32"] == 0, (
            name, by, launches[name])


def check_recorded(phase: str, name: str, recorded: list) -> list:
    errs = [KERNELS[name][3](a, kw) for a, kw in recorded]
    emit("main_path_parity", of=phase, kernel=name, inputs=len(errs),
         shapes=sorted({tuple(a[0].shape[:2]) for a, _ in recorded}),
         max_abs_err=max(errs))
    return errs


def phase_serving(dev, phase: str, cfg, initial: Tunables, space: dict,
                  per_call: dict):
    """KERMIT tuning a live server of ``cfg`` at full width (bf16, random
    weights from seed 0): diurnal night -> day traffic through
    ``KermitSession`` + ``ServeExecutor``, with the asserts of
    tests/test_serving_autonomic.py.  ``per_call``: launches of each
    kernel per serve call (its layers that run it once per prefill)."""
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, seed=0, initial=initial, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    traffic = TrafficGenerator.diurnal(window_size=8, seed=0,
                                       night_windows=12, day_windows=12)
    ex = ServeExecutor(eng, traffic, config=ServeConfig(probe_repeats=3),
                       initial=initial)
    events, seen, reports = [], [], []
    on_path = {k: n for k, n in per_call.items() if n}
    first = {k: {} for k in on_path}
    last = {k: collections.deque(maxlen=n) for k, n in on_path.items()}
    calls0 = eng.stats["serve_calls"]
    with contextlib.ExitStack() as stack:
        stack.enter_context(dbscan_inputs(seen))
        for name, n in on_path.items():
            stack.enter_context(launch_inputs(name, first[name], last[name],
                                              n))
        stack.enter_context(capture(eng, "serve", reports,
                                    lambda a, out: out))
        session = stack.enter_context(KermitSession(
            serve_config(initial, space), executor=ex, device=dev))
        session.subscribe(None, events.append)
        reset_counters()
        t0 = time.perf_counter()
        final = run_serving_session(session, ex)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counters()
        analyses = sum(e.kind == "analysis" for e in session.events)
    calls = eng.stats["serve_calls"] - calls0

    wl = ex.window_log
    change_w = traffic.phase_boundaries()[0]
    changes = [wl[i]["window"] for i in range(1, len(wl))
               if wl[i]["tunables"] != wl[i - 1]["tunables"]]
    replans = [w for w in changes if w >= change_w]
    kinds = {e.kind for e in events}
    assert len(wl) == traffic.n_windows, len(wl)
    assert replans, (changes, sorted(kinds))
    assert EventKind.DRIFT.value in kinds and EventKind.RETUNE.value in kinds
    assert final == ex.current, (final, ex.current)
    assert calls == len(reports) > 0, (calls, len(reports))
    for name in ("flash_attention", "ssd_scan"):
        assert launches[name] == per_call.get(name, 0) * calls, (
            name, launches[name], calls)
    assert_tensor_core_route(launches)
    nbr_launches = launches["nbr_adjacency"]
    assert nbr_launches == analyses == len(seen) > 0, (nbr_launches, analyses)
    assert launches["pairdist"] == 0, launches
    w0 = replans[0]
    before = [w["p99"] for w in wl if change_w <= w["window"] < w0]
    p99_before = statistics.median(before) if before else None
    p99_after = statistics.median(w["p99"] for w in wl if w["window"] >= w0)
    assert p99_before is None or p99_after <= p99_before, (p99_after,
                                                           p99_before)

    def phase_stats(name):
        rows = [w for w in wl if w["phase"] == name]
        return {"windows": len(rows),
                "p99_median_s": statistics.median(w["p99"] for w in rows),
                "mean_latency_s": statistics.mean(w["mean"] for w in rows),
                "tokens_per_s_median": statistics.median(
                    w["tokens_per_s"] for w in rows)}
    by_shape = collections.defaultdict(list)
    for r in reports:
        by_shape[(r.batch, r.prompt_len)].append(r)
    emit(phase, model=cfg.name, params_init_s=init_s, seconds=seconds,
         windows=len(wl), serve_calls=calls, decode_steps=sum(
             r.steps for r in reports), analyses=analyses,
         kernel_launches=launches,
         retunes=[(e.window_id, e.tunables["serve_batch"]) for e in events
                  if e.kind == EventKind.RETUNE.value],
         # what each decision saw: the session's events but transitions,
         # and every window's measured p99 and tunables' serve_batch
         events=[(e.window_id, e.kind, e.label) for e in events
                 if e.kind != EventKind.TRANSITION.value],
         window_p99=[(w["window"], w["p99"], w["tunables"]["serve_batch"])
                     for w in wl],
         changes=changes, first_day_replan=w0,
         p99_day_before_replan=p99_before, p99_day_after_replan=p99_after,
         night=phase_stats("night"), day=phase_stats("day"),
         final={k: getattr(final, k) for k in ("serve_batch", "cache_len",
                                               "ssm_chunk", "attn_impl")},
         per_call={f"B{b}xS{s}": {
             "calls": len(rs),
             "prefill_s_median": statistics.median(r.prefill_s for r in rs),
             "decode_s_per_step_median": statistics.median(
                 r.decode_s / max(r.steps, 1) for r in rs)}
             for (b, s), rs in sorted(by_shape.items())})

    # every layer of the first prefill of each shape the path ran, and of
    # the last prefill
    shapes = sorted({(r.batch, r.prompt_len) for r in reports})
    parity = {}
    for name, n in on_path.items():
        recorded = [r for recs in first[name].values() for r in recs] + \
            list(last[name])
        assert all(len(recs) == n for recs in first[name].values())
        compared = sorted({tuple(a[0].shape[:2]) for a, _ in recorded})
        assert compared == shapes, (name, compared, shapes)
        parity[name] = check_recorded(phase, name, recorded)
    nbr = check_main_path(phase, seen, dev)
    return eng, {"launches": launches, "parity": parity, "nbr_parity": nbr}


def phase_serving_parity(dev, eng, phase: str, initial: Tunables) -> None:
    """Prefill logits on the pallas route against the xla route: the
    reduced config in fp32 (asserted at 1e-4), the full model in bf16
    (printed), and greedy decodes of one day-phase call on both routes."""
    tol = 1e-4
    small = reduced(get_config(eng.cfg.name))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init(gen, small)
    batch = {"tokens": torch.randint(0, small.vocab, (4, 48), generator=gen,
                                     device=dev, dtype=torch.int32)}
    lp = M.forward(params, small, batch, initial)[0]
    lx = M.forward(params, small, batch, initial.replace(attn_impl="xla"))[0]
    err = float((lp - lx).abs().max())
    if not torch.allclose(lp, lx, rtol=tol, atol=tol):
        raise AssertionError(f"reduced {small.name} pallas vs xla logits: "
                             f"{err}")
    B, S = MAIN_SHAPE
    tok = eng._token_batch(S, B)
    fp = M.forward(eng.params, eng.cfg, tok, initial)[0]
    fx = M.forward(eng.params, eng.cfg, tok,
                   initial.replace(attn_impl="xla"))[0]
    gp = eng.serve(batch=B, prompt_len=S, gen=16, tunables=initial).generated
    gx = eng.serve(batch=B, prompt_len=S, gen=16,
                   tunables=initial.replace(attn_impl="xla")).generated
    emit(phase, model=eng.cfg.name, reduced_fp32_max_abs_err=err,
         tolerance=tol,
         full_bf16_max_abs_logit_diff=float((fp.float() - fx.float())
                                            .abs().max()),
         full_bf16_logit_absmax=float(fx.float().abs().max()),
         full_bf16_last_argmax_agree=float(
             (fp[:, -1].argmax(-1) == fx[:, -1].argmax(-1)).float().mean()),
         full_bf16_greedy_token_agree=float((gp == gx).mean()),
         full_bf16_greedy_first_token_agree=float(
             (gp[:, 0] == gx[:, 0]).mean()))


def profile_serve(eng, initial: Tunables, kernel_names: dict) -> dict:
    """One day-phase serve call (B = 8, prompt 48, 16 new tokens) under
    the profiler; ``kernel_names``: result key -> substring of a kernel's
    name, whose per-launch device ms are returned."""
    B, S = MAIN_SHAPE
    per_kernel = {}
    prof = device_profile(lambda: eng.serve(batch=B, prompt_len=S, gen=16,
                                            tunables=initial), per_kernel)
    dev_ms = {key: [t / n for name, (n, t) in per_kernel.items()
                    if sub in name] for key, sub in kernel_names.items()}
    emit("profile", what=f"serve call B={B} prompt={S} gen=16 "
         f"({eng.cfg.name}, bf16, pallas)", **{f"{k}_ms": v for k, v in
                                                dev_ms.items()}, **prof)
    return dev_ms


def phase_hybrid(dev, batches=(2, 8), prompt: int = 48, gen: int = 8):
    """zamba2-7b at full width behind ServeEngine on the pallas route: a
    few serve calls, every SSD layer (81) and every shared-block hit (13)
    of each prefill through the kernels, each recorded input held against
    the plain versions; then one call under the profiler."""
    cfg = get_config("zamba2-7b")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, seed=0, initial=HYBRID_TUN, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    per_call = {"flash_attention": cfg.n_layers // cfg.hybrid_period,
                "ssd_scan": cfg.n_layers}
    first = {k: {} for k in per_call}
    last = {k: collections.deque(maxlen=n) for k, n in per_call.items()}
    with contextlib.ExitStack() as stack:
        for name, n in per_call.items():
            stack.enter_context(launch_inputs(name, first[name], last[name],
                                              n))
        reset_counters()
        t0 = time.perf_counter()
        reports = [eng.serve(batch=B, prompt_len=prompt, gen=gen)
                   for B in batches]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = counters()
    for name, n in per_call.items():
        assert launches[name] == n * len(reports), (name, launches)
    assert_tensor_core_route(launches)
    parity = {}
    t0 = time.perf_counter()
    for name, n in per_call.items():
        recorded = [r for recs in first[name].values() for r in recs]
        assert len(recorded) == n * len(reports), (name, len(recorded))
        parity[name] = check_recorded("hybrid", name, recorded)
    emit("hybrid", model=cfg.name, params_init_s=init_s, serve_s=serve_s,
         parity_s=time.perf_counter() - t0,
         kernel_launches=launches, per_prefill=per_call,
         calls=[{"batch": r.batch, "prompt": r.prompt_len, "gen": r.steps,
                 "prefill_s": r.prefill_s,
                 "decode_s_per_step": r.decode_s / max(r.steps, 1),
                 "finite": bool(np.isfinite(r.generated).all())}
                for r in reports])
    dev_ms = profile_serve(eng, HYBRID_TUN, {"flash": "flash_fwd_wgmma",
                                             "ssd": "ssd_fwd_mma"})
    return {"launches": launches, "parity": parity, "device_ms": dev_ms}


# ---------------------------------------------------------------------------
# training: KERMIT tuning a live qwen2-1.5b training job
# ---------------------------------------------------------------------------

# examples/autonomic_train.py: the live search space (:31-35), phase a and
# phase b (:37-40), the optimizer and the session (:44-49)
LIVE_SPACE = {"remat": ["dots", "none", "full"], "microbatches": [1, 2, 4],
              "attn_q_chunk": [64, 128, 256]}
TRAIN_SHAPE = ShapeSpec("a", 128, 8, "train")
SSM_TRAIN_SHAPE = ShapeSpec("b", 256, 4, "train")
TRAIN_OC = OptConfig(lr=1e-3, warmup=5)
TRAIN_TUN = Tunables(attn_impl="pallas")
# the session analyses first at window 10 (min_windows 8, every 5
# windows of 4 steps) and searches at the next: 48 steps, 12 windows
TRAIN_STEPS = 48
SSM_TRAIN_STEPS = 6
# flash at the training shape: qwen2's heads at B = 8, S = 128; SSD at
# mamba2's phase b, one chunk of 256
FLASH_TRAIN = (8, 128)
SSD_TRAIN = (4, 256, 256)


def train_session_config() -> KermitConfig:
    """The example's session, with the run's tunables as the plug-in's
    default (J^D), as the serving phases do: else its first decision
    would put the run back on ``attn_impl="auto"``, the xla route."""
    return KermitConfig(
        monitor=MonitorConfig(window_size=4),
        analysis=AnalysisConfig(interval=5, dbscan_eps=0.25),
        plan=PlanConfig(space=LIVE_SPACE,
                        default_tunables=TRAIN_TUN.as_dict()))


@contextlib.contextmanager
def count_entries(owner, name: str, counts: collections.Counter):
    """Count the calls of ``owner.name`` as they start (a recompute that
    stops early never returns)."""
    real = getattr(owner, name)

    def run(*a, **kw):
        counts[name] += 1
        return real(*a, **kw)
    setattr(owner, name, run)
    try:
        yield
    finally:
        setattr(owner, name, real)


def finite_losses(losses) -> bool:
    return bool(losses) and all(np.isfinite(x) for x in losses)


def peak_gb(fn) -> float:
    """Peak device memory while ``fn`` runs, above what was allocated
    before it, in GB."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def remat_memory(tr, batch) -> dict:
    """For each remat policy: the peak memory of one forward + backward
    (loss and every gradient) and of one whole train step, above the live
    state, at the training shape."""
    out = {}
    for remat in ("none", "dots", "full"):
        tun = tr.tun.replace(remat=remat, microbatches=1)
        step = make_train_step(tr.cfg, tr.oc, tun, device=tr.device)
        out[remat] = {
            "fwd_bwd_gb": peak_gb(lambda: loss_and_grads(
                tr.state["params"], tr.cfg, batch, tun)),
            "step_gb": peak_gb(lambda: step(tr.state, batch))}
    return out


def phase_training(dev) -> dict:
    """KERMIT tuning a live qwen2-1.5b training job at full width (bf16,
    random weights from seed 0): ``Trainer`` + ``KermitSession`` with
    examples/autonomic_train.py's session, phase a's shape and
    ``attn_impl="pallas"``.  Asserts finite losses, every flash launch
    bf16 (wgmma) and one per layer run (forward passes and remat
    recomputes, counted), an ANALYSIS with each ε-neighbour launch held
    to its plain version, no failed trial, and peak memory ordered
    full <= dots <= none; profiles one train step."""
    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    session = KermitSession(train_session_config(), device=dev)
    tr = Trainer(cfg, TRAIN_SHAPE, TRAIN_OC, TRAIN_TUN, autonomic=session,
                 seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trials = []
    real_objective = tr.measured_objective

    def measured_objective(repeats: int = 1):
        objective = real_objective(repeats)

        def record(tun):
            cost = objective(tun)
            trials.append({"remat": tun.remat,
                           "microbatches": tun.microbatches,
                           "attn_q_chunk": tun.attn_q_chunk, "s": cost})
            return cost
        return record
    tr.measured_objective = measured_objective
    events, seen, calls = [], [], collections.Counter()
    first, last = {}, collections.deque(maxlen=cfg.n_layers)
    session.subscribe(None, events.append)
    with contextlib.ExitStack() as stack:
        stack.enter_context(dbscan_inputs(seen))
        stack.enter_context(launch_inputs("flash_attention", first, last,
                                          cfg.n_layers))
        stack.enter_context(count_entries(T, "block_apply", calls))
        stack.enter_context(count_entries(M, "forward", calls))
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = tr.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counters()
        peak = torch.cuda.max_memory_allocated() / 1e9
    analyses = sum(e.kind == "analysis" for e in session.events)
    layer_runs = calls["block_apply"]
    assert rep.steps_done == TRAIN_STEPS and finite_losses(rep.losses), rep
    assert launches["flash_attention"] == layer_runs > 0, (launches,
                                                           layer_runs)
    assert layer_runs % cfg.n_layers == 0, layer_runs
    assert layer_runs >= cfg.n_layers * calls["forward"], (layer_runs, calls)
    assert_tensor_core_route(launches)
    assert launches["ssd_scan"] == launches["pairdist"] == 0, launches
    assert analyses >= 1, [e.kind for e in events]
    assert launches["nbr_adjacency"] == analyses == len(seen), (launches,
                                                                 analyses)
    assert tr.failed_trials == 0 and rep.failed_trials == 0, tr.trial_errors

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in tr.pipeline._make(0).items()}
    memory = remat_memory(tr, batch)
    fb = {k: v["fwd_bwd_gb"] for k, v in memory.items()}
    assert fb["full"] <= fb["dots"] <= fb["none"] and fb["full"] < fb["none"], \
        memory
    step = make_train_step(cfg, TRAIN_OC, TRAIN_TUN, device=dev)
    prof = device_profile(lambda: step(tr.state, batch))
    emit("profile", what=f"train step B={TRAIN_SHAPE.global_batch} "
         f"S={TRAIN_SHAPE.seq_len} (qwen2-1.5b, bf16, pallas, remat dots)",
         **prof)
    emit("training", model=cfg.name, params_init_s=init_s, seconds=seconds,
         steps=rep.steps_done, step_s=rep.step_times,
         step_s_median=statistics.median(rep.step_times),
         loss_first=rep.losses[0], loss_last=rep.losses[-1],
         forward_passes=calls["forward"], layer_runs=layer_runs,
         flash_launches_per_step_dots=2 * cfg.n_layers,
         kernel_launches=launches, analyses=analyses,
         retunes=[(s, t["remat"], t["microbatches"], t["attn_q_chunk"])
                  for s, t in rep.retunes],
         final={k: rep.final_tunables[k] for k in LIVE_SPACE},
         events=[(e.window_id, e.kind, e.label) for e in events
                 if e.kind != EventKind.TRANSITION.value],
         trials=trials, failed_trials=rep.failed_trials,
         straggler_events=rep.straggler_events,
         max_memory_allocated_gb=peak, remat_memory_gb=memory,
         summary=session.summary()["plugin"])
    session.close()
    recorded = [r for recs in first.values() for r in recs] + list(last)
    with torch.no_grad():
        flash_parity = check_recorded("training", "flash_attention",
                                      recorded)
    nbr = check_main_path("training", seen, dev)
    return {"trainer": tr, "batch": batch, "launches": launches,
            "parity": flash_parity, "nbr_parity": nbr, "profile": prof}


# pallas vs xla train step at bf16: loss and grad norm, relative.  The two
# routes' attention outputs differ by up to one bf16 step (flash_tol), and
# that difference runs through 28 layers and the backward.
TRAIN_TOL = 1e-2
# each gradient leaf's relative (Frobenius) difference between the routes
LEAF_TOL = 5e-2
# the Functions' grads against autograd through the plain versions: both
# differentiate the same recompute (attention_xla / ssd_chunked) with the
# same output grads, so they agree to the last bits in fp32 and to one
# bf16 step in bf16
GRAD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}


def rel(a, b) -> float:
    """|a - b| / |b| over all elements (Frobenius), in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def function_grads(fn, ref, inputs, tol) -> dict:
    """The Function's forward and input grads (kernel forward on the card)
    against autograd through its plain version on the same inputs and the
    same output grads: every grad present, non-zero and within ``tol``
    (atol, rtol); the forward within the kernel's tolerance is held by
    ``compare_*``."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    g = torch.Generator(device=out[0].device).manual_seed(7)
    gouts = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
             for o in out]
    got = torch.autograd.grad(out, leaves, gouts)
    leaves_r = [t.detach().requires_grad_() for t in inputs]
    out_r = ref(*leaves_r)
    out_r = out_r if isinstance(out_r, tuple) else (out_r,)
    want = torch.autograd.grad(out_r, leaves_r, gouts)
    errs = []
    for a, b in zip(got, want):
        assert a is not None and bool(a.abs().sum() > 0), "gradient dropped"
        atol, rtol = tol
        err = float((a.float() - b.float()).abs().max())
        if not torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"Function grad differs by {err}")
        errs.append(err)
    return {"grad_max_abs_err": errs,
            "forward_max_abs_err": max(float((o - r).detach().float().abs()
                                             .max()) for o, r in
                                       zip(out, out_r))}


def phase_training_parity(dev, trained: dict) -> dict:
    """One train step from the trained weights and phase a's batch on the
    pallas and the xla route: loss and grad norm within ``TRAIN_TOL``,
    every gradient leaf non-zero on both and within ``LEAF_TOL`` of the
    xla route's (relative norm).  Then the Functions' input grads at the
    training shapes, fp32 and bf16, against autograd through the plain
    versions."""
    tr, batch = trained["trainer"], trained["batch"]
    out = {}
    grads = {}
    for impl in ("pallas", "xla"):
        tun = tr.tun.replace(attn_impl=impl, remat="dots", microbatches=1)
        metrics = make_train_step(tr.cfg, tr.oc, tun, device=dev)(
            tr.state, batch)[1]
        out[impl] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        del metrics
        grads[impl] = loss_and_grads(tr.state["params"], tr.cfg, batch,
                                     tun)[2]
    leaves = {impl: tree_leaves(g) for impl, g in grads.items()}
    leaf_rel = [rel(a, b) for a, b in zip(leaves["pallas"], leaves["xla"])]
    zero = [i for i, (a, b) in enumerate(zip(leaves["pallas"],
                                             leaves["xla"]))
            if not (bool(a.abs().sum() > 0) and bool(b.abs().sum() > 0))]
    del grads, leaves
    release_memory()
    d = {k: abs(out["pallas"][k] - out["xla"][k]) / abs(out["xla"][k])
         for k in ("loss", "grad_norm")}
    assert not zero, f"gradient leaves that are zero: {zero}"
    assert max(d.values()) <= TRAIN_TOL, (out, d)
    assert max(leaf_rel) <= LEAF_TOL, leaf_rel

    B, S = FLASH_TRAIN
    fn = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attn_inputs(dev, B, S, S, dtype=dtype, seed=5, **QWEN2)
        fn[f"flash_{str(dtype)[6:]}"] = function_grads(
            lambda a, b, c: FA.flash_attention(a, b, c, causal=True),
            lambda a, b, c: FA._ref(a, b, c, True, 0, 0.0), (q, k, v),
            GRAD_TOL[dtype])
        Bs, Ss, Q = SSD_TRAIN
        args = ssd_inputs(dev, Bs, Ss, dtype=dtype, seed=6, **MAMBA2)
        fn[f"ssd_{str(dtype)[6:]}"] = function_grads(
            lambda *a: SSD.ssd(*a, chunk=Q),
            lambda *a: SSD._ref(*a, Q), args, GRAD_TOL[dtype])
    emit("training_parity", model=tr.cfg.name, routes=out,
         relative_diff=d, tolerance=TRAIN_TOL, grad_leaves=len(leaf_rel),
         grad_leaf_relative_diff_max=max(leaf_rel),
         grad_leaf_tolerance=LEAF_TOL, functions=fn,
         function_grad_tolerance={str(k): v for k, v in GRAD_TOL.items()})
    return {"routes": out, "relative_diff": d, "functions": fn}


def phase_training_ssm(dev) -> dict:
    """mamba2-1.3b training at full width (bf16, seed 0), phase b's shape,
    ``attn_impl="pallas"`` with the default ssm_chunk 256 and int8 AdamW
    moments, no session: finite losses, one SSD launch (bf16, mma.sync)
    per SSD layer run (forward passes and remat recomputes, counted), each
    recorded input held to the plain version."""
    cfg = get_config("mamba2-1.3b")
    oc = dataclasses.replace(TRAIN_OC, moments_dtype="int8")
    t0 = time.perf_counter()
    tr = Trainer(cfg, SSM_TRAIN_SHAPE, oc, TRAIN_TUN, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calls = collections.Counter()
    first, last = {}, collections.deque(maxlen=cfg.n_layers)
    with contextlib.ExitStack() as stack:
        stack.enter_context(launch_inputs("ssd_scan", first, last,
                                          cfg.n_layers))
        stack.enter_context(count_entries(SLM, "_ssm_block", calls))
        stack.enter_context(count_entries(M, "forward", calls))
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = tr.run(SSM_TRAIN_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counters()
        peak = torch.cuda.max_memory_allocated() / 1e9
    runs = calls["_ssm_block"]
    moments = {str(tree_leaves(tr.state["opt"]["m"])[0][0].dtype)}
    assert finite_losses(rep.losses), rep.losses
    assert launches["ssd_scan"] == runs > 0 and runs % cfg.n_layers == 0, (
        launches, runs)
    assert runs >= cfg.n_layers * calls["forward"], (runs, calls)
    assert launches["flash_attention"] == 0, launches
    assert_tensor_core_route(launches)
    assert moments == {"torch.int8"}, moments
    recorded = [r for recs in first.values() for r in recs] + list(last)
    with torch.no_grad():
        parity = check_recorded("training_ssm", "ssd_scan", recorded)
    emit("training_ssm", model=cfg.name, params_init_s=init_s,
         seconds=seconds, steps=rep.steps_done, step_s=rep.step_times,
         losses=rep.losses, forward_passes=calls["forward"],
         ssd_layer_runs=runs, kernel_launches=launches,
         moments_dtype=oc.moments_dtype, max_memory_allocated_gb=peak)
    del tr
    return {"launches": launches, "parity": parity}


# resumed against uninterrupted losses: CUDA may sum with atomics in no
# fixed order (the card's runs so far were bit-equal all the same)
FT_TOL = 1e-4


def phase_fault_tolerance(dev) -> dict:
    """examples/fault_tolerance.py on the card: reduced qwen3-14b (2 layers,
    vocab 256), checkpoints every 5 steps, node failures at steps 8 and
    17, 25 steps: 2 recoveries, and the steps after the last recovery
    allclose (``FT_TOL``) to an uninterrupted run's."""
    cfg = reduced(get_config("qwen3-14b")).replace(n_layers=2, vocab=256)
    shape = ShapeSpec("ft", 128, 4, "train")
    oc = OptConfig(lr=1e-3)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        rep = Trainer(cfg, shape, oc, DEFAULT_TUNABLES,
                      ckpt_dir=Path(d) / "a", ckpt_every=5,
                      injector=FailureInjector(fail_steps=(8, 17)),
                      device=dev).run(25)
    base = Trainer(cfg, shape, oc, DEFAULT_TUNABLES, device=dev).run(25)
    seconds = time.perf_counter() - t0
    # the run replays from step 15 (the checkpoint before step 17) to 24
    resumed, want = np.asarray(rep.losses[-10:]), np.asarray(base.losses[15:])
    err = float(np.max(np.abs(resumed - want) / np.abs(want)))
    assert rep.steps_done == 25 and rep.failures_recovered == 2, rep
    assert finite_losses(rep.losses) and len(rep.losses) == 25 + 3 + 2
    assert np.allclose(resumed, want, rtol=FT_TOL, atol=0), (resumed, want)
    emit("fault_tolerance", model=f"reduced {cfg.name}", seconds=seconds,
         steps=rep.steps_done, failures_recovered=rep.failures_recovered,
         straggler_events=rep.straggler_events,
         loss_first=rep.losses[0], loss_last=rep.losses[-1],
         resumed_max_relative_diff=err, tolerance=FT_TOL,
         bit_equal=bool(np.array_equal(resumed, want)))
    return {"resumed_max_relative_diff": err}


# ---------------------------------------------------------------------------
# the self-healing path: scenarios, durable sessions, the model-guided Plan
# ---------------------------------------------------------------------------

def count_calls(owner, name: str, log: list):
    """Count the calls of ``owner.name`` (a class's method too) in ``log``."""
    return capture(owner, name, log, lambda a, out: None)


def phase_scenarios(dev, seeds=(0, 1)) -> dict:
    """The manifest's ported scenarios (the session, crash, serving and
    fleet kinds) at both manifest seeds through ``repro_torch.scenarios``
    on the card: every gate true.  The ε-neighbour kernel runs once per
    analysis (the crash kind's two supervised runs and its replay, the
    ``winner_matches_clean`` reruns and the fleet kind's isolated sessions
    included)."""
    man = load_manifest()
    names = [n for n, spec in man["scenarios"].items()
             if spec.get("kind", "session") not in UNPORTED_KINDS]
    left_out = {n: UNPORTED_KINDS[spec["kind"]]
                for n, spec in man["scenarios"].items()
                if spec.get("kind", "session") in UNPORTED_KINDS}
    emit("scenarios_left_out", scenarios=left_out)
    base = json.loads((ROOT / "benchmarks" / "baselines" /
                       "BENCH_scenarios.json").read_text())
    base = next(iter(base.values()))["value"]["scenarios"]
    seen, analyses = [], []
    with tempfile.TemporaryDirectory() as out, dbscan_inputs(seen), \
            count_calls(A.KermitAnalyser, "run", analyses):
        reset_counters()
        t0 = time.perf_counter()
        summary = run_manifest(out_dir=out, run_id="chip", only=names,
                               seeds=list(seeds), device=dev)
        seconds = time.perf_counter() - t0
        launches = counters()
        arts = {(r["scenario"], r["seed"]): json.loads(
            (Path(out) / "chip" / r["artifact"]).read_text())
            for r in summary["runs"]}
    assert summary["scenarios"] == names and len(names) == 9, names
    assert summary["device"] == str(dev), summary["device"]
    per = []
    for (name, seed), art in arts.items():
        failed = [k for k, g in art["gates"].items() if not g["pass"]]
        assert art["ok"] and not failed, (name, seed, art["gates"])
        want = base[f"{name}--seed{seed}--auto"]
        assert set(art["gates"]) == set(want["gates"]), (name, want)
        m = art["metrics"]
        per.append({"scenario": name, "seed": seed,
                    "seconds": art["seconds"],
                    "gates": {k: g["value"] for k, g in art["gates"].items()},
                    "recovery_ratio": m.get("recovery_ratio"),
                    "baseline_recovery_ratio": want["recovery_ratio"],
                    "windows": m["windows"], "retunes": m["retunes"],
                    "evaluations": m["evaluations"],
                    "analyses": m["events"].get("analysis", 0)})
        emit("scenario", **per[-1])
    assert len(analyses) == len(seen) > 0, (len(analyses), len(seen))
    if dev.type == "cuda":
        assert launches["nbr_adjacency"] == len(analyses), launches
        assert launches["pairdist"] == launches["flash_attention"] == \
            launches["ssd_scan"] == 0, launches
    emit("scenarios", seconds=seconds, runs=len(summary["runs"]),
         all_ok=summary["all_ok"], analyses_run=len(analyses),
         kernel_launches=launches["nbr_adjacency"],
         seconds_by_scenario={n: sum(p["seconds"] for p in per
                                     if p["scenario"] == n) for n in names})
    return {"launches": launches["nbr_adjacency"],
            "parity": check_main_path("scenarios", seen, dev)}


def durable_decisions(session) -> dict:
    """What the loop decided: events without RESTORE and CHECKPOINT (their
    windows, kinds and labels), the RETUNE tunables, the monitor's labels
    and the final tunables."""
    evs = [e for e in session.events
           if e.kind not in (EventKind.RESTORE.value,
                             EventKind.CHECKPOINT.value)]
    return {"events": [(e.window_id, str(e.kind), e.label) for e in evs],
            "retunes": [e.tunables for e in evs
                        if e.kind == EventKind.RETUNE.value],
            "labels": session.monitor.label_log.tolist(),
            "final": session.current.as_dict()}


def phase_durable_history(dev, full: dict, n_windows: int = 4096,
                          interval: int = 512, crash_at: int = 2600):
    """``full_history``'s config and stream (the default KermitConfig,
    retention 4096, 16 features, ε 0.35, analysis every 512) under
    ``KermitSupervisor``, a snapshot every 512 windows: once uninterrupted,
    once with a ``CrashFault`` at ``crash_at``, between two snapshots.
    Gate (``tests/test_scenarios.py:295-340``): the two runs decide alike
    (events, RETUNE tunables, monitor labels, final tunables), one crash,
    one restore; and as ``full_history`` did.  Prints the snapshot's bytes
    (the arrays', and the JSON meta's by field, the retained contexts
    apart) and one checkpoint's and one restore's seconds at this size."""
    config = KermitConfig(analysis=AnalysisConfig(interval=interval),
                          monitor=MonitorConfig(retention=n_windows),
                          execute=ExecConfig(checkpoint_every=interval))
    n_seg = -(-n_windows // 66) + 1
    schedule = [(ARCHETYPES[i % len(ARCHETYPES)], 64) for i in range(n_seg)]

    def factory(faults):
        return lambda: ChaosExecutor(
            SimulatorExecutor(schedule, window_size=32, seed=0, device=dev),
            list(faults), seed=0, window_size=32)
    samples = factory(())().samples[:n_windows * 32]
    runs, seen = {}, []
    with tempfile.TemporaryDirectory() as d, dbscan_inputs(seen):
        for name, faults in (("clean", ()),
                             ("crash", (CrashFault(at_window=crash_at),))):
            sup = KermitSupervisor(config, factory(faults),
                                   checkpoint_path=Path(d) / f"{name}.npz",
                                   device=dev)
            reset_counters()
            t0 = time.perf_counter()
            report = sup.run(samples)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "launches": counters()["nbr_adjacency"],
                          "report": report, "session": sup.session}
        clean, crash = runs["clean"], runs["crash"]
        s = crash["session"]
        snap = Path(d) / "timed.npz"
        t0 = time.perf_counter()
        s.checkpoint(snap)
        checkpoint_s = time.perf_counter() - t0
        size = snap.stat().st_size
        arrays, meta = load_snapshot(snap)
        parts = {"arrays": sum(a.nbytes for a in arrays.values()),
                 **{f"meta.{k}": len(json.dumps(v)) for k, v in meta.items()
                    if k not in ("monitor",)},
                 "meta.monitor.contexts": len(json.dumps(
                     meta["monitor"]["contexts"]))}
        t0 = time.perf_counter()
        restored = KermitSession.restore(
            snap, executor=factory((CrashFault(at_window=crash_at),))(),
            device=dev)
        restore_s = time.perf_counter() - t0
        assert restored.monitor.label_log.tolist() == \
            s.monitor.label_log.tolist()
        restored.close()
    want, got = (durable_decisions(r["session"]) for r in (clean, crash))
    rep = crash["report"]
    assert rep["crashes"] == rep["restores"] == 1, rep
    assert clean["report"]["crashes"] == 0
    assert rep["windows"] == clean["report"]["windows"] == n_windows
    for key in ("events", "retunes", "labels", "final"):
        assert got[key] == want[key], key
    restores = [e for e in s.events if e.kind == EventKind.RESTORE.value]
    assert len(restores) == 1
    analyses = sum(e[1] == "analysis" for e in want["events"])
    assert analyses == n_windows // interval, analyses
    if dev.type == "cuda":
        assert clean["launches"] == analyses, clean["launches"]
        assert crash["launches"] >= clean["launches"]
    retunes = [(t["microbatches"], t["remat"], t["attn_q_chunk"])
               for t in want["retunes"]]
    assert retunes == [r[1:] for r in full["retunes"]], retunes
    assert (want["final"]["microbatches"], want["final"]["remat"],
            want["final"]["attn_q_chunk"]) == full["final"]
    emit("durable_history", windows=n_windows, checkpoint_every=interval,
         crash_at_window=crash_at,
         restored_from_window=restores[0].detail["window"],
         seconds={k: r["seconds"] for k, r in runs.items()},
         checkpoints={k: r["report"]["checkpoints"] for k, r in runs.items()},
         kernel_launches={k: r["launches"] for k, r in runs.items()},
         analyses_replayed=crash["launches"] - clean["launches"],
         snapshot_bytes=size, snapshot_part_bytes=parts,
         checkpoint_s=checkpoint_s,
         restore_s=restore_s, events=len(want["events"]),
         retunes=len(retunes), decisions_equal=True)
    for r in runs.values():
        r["session"].close()
    return {"launches": clean["launches"] + crash["launches"],
            "parity": check_main_path("durable_history", seen, dev)}


def seeded_objective(seed: int, space: dict):
    """``tests/oracles.py``'s separable objective: each knob value draws an
    independent weight from ``seed``; a candidate costs their sum."""
    rng = np.random.default_rng(seed)
    weights = {k: {v: float(w) for v, w in zip(values, rng.uniform(
        0.0, 1.0, size=len(values)))} for k, values in space.items()}
    return lambda tun: sum(weights[k][getattr(tun, k)] for k in weights)


def exhaustive_oracle_cost(objective, space: dict) -> float:
    """The brute-force optimum over the grid (``tests/oracles.py``)."""
    ex = Explorer(space)
    return min(float(objective(ex._decode_index(DEFAULT_TUNABLES, i)))
               for i in range(ex.grid_size()))


def plan_scenario(dev, seed: int, **plugin_kw):
    """``benchmarks/bench_costmodel.py``'s scenario on the card: a tuned
    donor class with its banked trace (a hill-climb's plus 300 seeded grid
    rows), a fresh far-away target class."""
    fn = seeded_objective(seed, DEFAULT_SPACE)
    char = lambda m: {"mean": np.full(8, m, np.float32),  # noqa: E731
                      "std": np.ones(8, np.float32), "n": 64}
    db = WorkloadDB(drift_eps=0.5, device=dev)
    donor = db.insert(char(1.0))
    ex = Explorer(DEFAULT_SPACE)
    db.set_config(donor, ex.global_search(fn).best.as_dict(), optimal=True)
    rows = list(Explorer(DEFAULT_SPACE).global_search(fn).trace)
    for i in np.random.default_rng(seed).choice(ex.grid_size(), size=300,
                                                replace=False):
        t = ex._decode_index(DEFAULT_TUNABLES, int(i))
        rows.append((t.as_dict(), float(fn(t))))
    db.record_trace(donor, rows)
    target = db.insert(char(5.0))
    plug = KermitPlugin(db, None, Explorer(DEFAULT_SPACE), **plugin_kw)
    ctx = WorkloadContext(window_id=0, timestamp=0.0, current_label=target,
                          predicted={}, in_transition=False)
    return plug, ctx, fn


PLAN_BUDGET = 0.10


def phase_plan_model(dev, seeds=(0, 1, 2)) -> None:
    """The two gates of ``benchmarks/bench_costmodel.py`` on the card: the
    model-guided Plan commits the oracle's cost within 10 % of the 5184-point
    grid (+1 for the incumbent probe), the cost model training on the card;
    ``model_guided=False`` is bit-identical to the unmodelled Plan."""
    base = json.loads((ROOT / "benchmarks" / "baselines" /
                       "BENCH_costmodel.json").read_text())
    base = {r["seed"]: r for r in next(iter(base.values()))["value"][
        "per_seed"]}
    per = []
    for seed in seeds:
        plug, ctx, fn = plan_scenario(dev, seed, model_guided=True,
                                      significance=0.1,
                                      eval_budget=PLAN_BUDGET)
        t0 = time.perf_counter()
        best = plug.on_resource_request(fn, ctx)
        seconds = time.perf_counter() - t0
        grid = plug.explorer.grid_size()
        oracle = exhaustive_oracle_cost(fn, DEFAULT_SPACE)
        st = plug.stats
        assert grid == 5184 and st.model_searches == 1 and \
            st.model_fallbacks == 0, vars(st)
        assert st.evaluations <= int(PLAN_BUDGET * grid) + 1, st.evaluations
        assert float(fn(best)) == oracle, (fn(best), oracle)
        assert plug._cost_model.device == dev
        per.append({"seed": seed, "evaluations": st.evaluations,
                    "grid": grid, "committed_cost": float(fn(best)),
                    "oracle_cost": oracle, "seconds": seconds,
                    "baseline_evaluations": base[seed]["evaluations"]})
        emit("plan_model", **per[-1])
    for seed in seeds:
        a, ctx_a, fn = plan_scenario(dev, seed)
        b, ctx_b, _ = plan_scenario(dev, seed, model_guided=False,
                                    significance=0.5, regret_bound=0.01,
                                    min_trace=1, eval_budget=0.5)
        best_a, best_b = (p.on_resource_request(fn, c)
                          for p, c in ((a, ctx_a), (b, ctx_b)))
        assert best_a == best_b and vars(a.stats) == vars(b.stats), seed
    emit("plan_model_gates", eval_fraction_max=max(
        p["evaluations"] / p["grid"] for p in per), budget=PLAN_BUDGET,
        oracle_cost_match=True, off_parity_bit_identical=True)


# ---------------------------------------------------------------------------
# the fleet (slice 7): KermitFleet at the reference benchmark's sizes, and
# the Fig-10 clustering comparison with kmeans
# ---------------------------------------------------------------------------

FLEET_WINDOW = 16                       # benchmarks/bench_fleet.py's WINDOW
FLEET_TRAIN_SCHED = [("dense_train", 30), ("moe_train", 30),
                     ("dense_train", 30)]
FLEET_STREAM_ARCHES = ["dense_train", "moe_train", "dense_train",
                       "decode_serve"]
FLEET_TENANTS = 256                     # bench_fleet.py:113-114, full mode
FLEET_WINDOWS = 32                      # cut from the benchmark's 64
FLEET_PARITY_TENANTS = 8                # bench_fleet.py:158-161
FLEET_PARITY_SCHED = [("dense_train", 30), ("moe_train", 30),
                      ("dense_train", 34)]
# benchmarks/baselines/BENCH_fleet.json's parity_transfer counts (the
# reference, JAX on the CPU): printed beside the port's, not gated
FLEET_REFERENCE = {"scalar_evaluations": 497, "fleet_evaluations": 469,
                   "warm_transfers": 29, "fleet_evals_saved": 12,
                   "analyses": 32, "plans": 58}


def fleet_trained_artifacts(dev, seed: int = 123):
    """``bench_fleet.py``'s ``_trained_artifacts``: one analysis of the
    training schedule, the forest and the LSTM fit by the port on ``dev``."""
    sim = generate(FLEET_TRAIN_SCHED, window_size=FLEET_WINDOW, seed=seed)
    an = A.KermitAnalyser(WorkloadDB(None, drift_eps=1.0, device=dev),
                          device=dev)
    an.run(make_windows(sim.samples, FLEET_WINDOW))
    assert an.predictor is not None, "training schedule too short for LSTM"
    return an.classifier, an.predictor


def fleet_traces(n_tenants: int, n_windows: int) -> np.ndarray:
    """``bench_fleet.py``'s ``_tenant_traces``: (S, T·W, F), the same
    schedule at per-tenant seeds, cut to equal lengths."""
    per = max(n_windows // len(FLEET_STREAM_ARCHES), 2)
    sched = [(a, per) for a in FLEET_STREAM_ARCHES]
    out = []
    for s in range(n_tenants):
        tr = generate(sched, window_size=FLEET_WINDOW, seed=s).samples
        out.append(tr[:(tr.shape[0] // FLEET_WINDOW) * FLEET_WINDOW])
    n = min(t.shape[0] for t in out)
    return np.stack([t[:n] for t in out])


def fleet_steady_config() -> KermitConfig:
    """``bench_fleet.py``'s ``_steady_config`` at the default retention
    (4096, not the benchmark's 256): no analysis in the timed region."""
    return KermitConfig(monitor=MonitorConfig(window_size=FLEET_WINDOW),
                        analysis=AnalysisConfig(interval=10 ** 9))


def record_ticks(fleet):
    """Make ``fleet`` record each tick's (labels, flags, predictions) in
    ``fleet.ticks_seen``."""
    fleet.ticks_seen = []
    real = fleet._tick

    def tick(mean, var):
        real(mean, var)
        _, labels, trans, preds, _ = fleet._last_ctx
        fleet.ticks_seen.append((labels, trans, preds))
    fleet._tick = tick
    return fleet


def tick_mismatches(fleet, sessions) -> list:
    """(tenant, window) pairs where a session's context differs from the
    fleet's tick in label, transition flag or horizon predictions."""
    out = []
    for s, sess in enumerate(sessions):
        for k, c in enumerate(sess.monitor.contexts):
            labels, trans, preds = fleet.ticks_seen[k]
            if (c.current_label != labels[s]
                    or c.in_transition != bool(trans[s])
                    or [c.predicted[h] for h in (1, 5, 10)]
                    != preds[:, s].tolist()):
                out.append((s, k))
    return out


def new_fleet(dev, traces, clf, pred):
    """A steady-state fleet with every tenant holding ``clf``/``pred``,
    recording its ticks."""
    fleet = KermitFleet(FleetConfig(tenants=traces.shape[0],
                                    base=fleet_steady_config(),
                                    transfer=False), device=dev)
    for t in range(fleet.tenants):
        mv = fleet._tenants[t].monitor
        mv.classifier, mv.predictor = clf, pred
    return record_ticks(fleet)


def runtime_calls(fn) -> dict:
    """The CUDA runtime calls ``fn`` makes, as the host records them under
    the profiler: stream syncs (``cudaStreamSynchronize``; the profiler's
    own ``cudaDeviceSynchronize`` when it stops is left out), copies
    (``cudaMemcpyAsync``) and kernel launches; and the copies' kinds as
    the device trace shows them (pinned or pageable host memory; a
    pageable host-to-device copy waits for the stream), which may miss
    the first few, as device traces here lose a prefix."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    names = collections.Counter(e.name for e in prof.events())
    return {"stream_syncs": names["cudaStreamSynchronize"],
            "copies": names["cudaMemcpyAsync"],
            "copy_kinds_seen": {k: n for k, n in sorted(names.items())
                                if k.startswith("Memcpy")},
            "kernels": names["cudaLaunchKernel"]}


def phase_fleet_ingest(dev) -> dict:
    """``bench_fleet.py``'s throughput scenario on the card: 256 tenants,
    32 windows of 16 samples each, the trained forest and LSTM in every
    monitor, no analysis.  The fleet pass against 256 isolated sessions
    (one ``step_batch`` per window): labels, flags and predictions equal
    per tenant and window; launches per tick equal at S = 8 and S = 256."""
    clf, pred = fleet_trained_artifacts(dev)
    traces = fleet_traces(FLEET_TENANTS, FLEET_WINDOWS)
    S, N, _ = traces.shape
    T = N // FLEET_WINDOW
    reset_counters()

    small = new_fleet(dev, traces[:8], clf, pred)    # also the warm-up
    small.ingest(traces[:8])
    fleet = new_fleet(dev, traces, clf, pred)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet.ingest(traces)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    dispatches = fleet.stats.dispatches
    assert fleet.stats.ticks == T and dispatches == T, vars(fleet.stats)

    sessions = []
    for _ in range(S):
        sess = KermitSession(fleet_steady_config(), device=dev)
        sess.monitor.classifier, sess.monitor.predictor = clf, pred
        sessions.append(sess)
    sessions[0].step_batch(traces[0, :FLEET_WINDOW])      # warm-up
    sessions[0] = KermitSession(fleet_steady_config(), device=dev)
    sessions[0].monitor.classifier = clf
    sessions[0].monitor.predictor = pred
    t0 = time.perf_counter()
    for k in range(T):
        lo, hi = k * FLEET_WINDOW, (k + 1) * FLEET_WINDOW
        for s in range(S):
            sessions[s].step_batch(traces[s, lo:hi])
    torch.cuda.synchronize()
    iso_s = time.perf_counter() - t0
    launches = counters()
    assert launches["nbr_adjacency"] == 0, launches   # no analysis here

    assert all(len(s.monitor.contexts) == T for s in sessions)
    mism = tick_mismatches(fleet, sessions)
    iso_calls = runtime_calls(lambda: sessions[0].step_batch(
        traces[0, -FLEET_WINDOW:]))
    for sess in sessions:
        sess.close()
    if mism:
        raise AssertionError(f"fleet monitor diverged from isolated "
                             f"sessions at (tenant, window) {mism[:8]}")
    labelled = np.stack([t[0] for t in fleet.ticks_seen])
    predicted = np.stack([t[2] for t in fleet.ticks_seen])
    assert (labelled >= 0).mean() > 0.5, "the forest labelled few windows"

    # a steady tick of each fleet, profiled: the last window again, after
    # two unprofiled repeats, so no tenant sees a transition or a new
    # label and the tick is the monitor step and its bookkeeping alone.
    # Launches per tick at S = 8 and S = 256, the tick's busy time and
    # idle share, and its syncs and copies.
    last = traces[:, -FLEET_WINDOW:]
    for f, x in ((small, last[:8]), (fleet, last)):
        f.ingest(x)
        f.ingest(x)
    plans = fleet.stats.plans
    prof_small = device_profile(lambda: small.ingest(last[:8]))
    prof = device_profile(lambda: fleet.ingest(last))
    calls = runtime_calls(lambda: fleet.ingest(last))
    assert fleet.stats.plans == plans, "a profiled tick planned"
    emit("profile", what="fleet tick S=8", **prof_small)
    emit("profile", what=f"fleet tick S={S}", **prof)
    assert prof_small["trace_complete"] and prof["trace_complete"], \
        (prof_small, prof)
    assert prof_small["launches"] == prof["launches"], \
        (prof_small["launches"], prof["launches"])
    assert calls["stream_syncs"] == 1 and calls["copies"] == 5, calls
    rec = {"tenants": S, "windows_per_tenant": T,
           "retention": fleet.ring.capacity,
           "ring_bytes": fleet.ring.mean.nbytes + fleet.ring.var.nbytes
           + fleet.ring.label.nbytes,
           "fleet_s": fleet_s, "isolated_s": iso_s,
           "fleet_windows_per_s": S * T / fleet_s,
           "isolated_windows_per_s": S * T / iso_s,
           "speedup": iso_s / fleet_s,
           "dispatches": dispatches,
           "launches_per_tick": {"S=8": prof_small["launches"],
                                 f"S={S}": prof["launches"]},
           "tick_runtime": calls, "isolated_step_runtime": iso_calls,
           "tick_busy_s": prof["device_busy_s"],
           "tick_idle_share": prof["idle_share"],
           "labelled_frac": float((labelled >= 0).mean()),
           # a prediction needs 16 labelled windows in a row; segments of
           # 8 windows between transitions give none here (fleet_parity's
           # 30-window segments do)
           "predicted_frac": float((predicted >= 0).mean()),
           "parity": "labels, flags and predictions bit-equal"}
    emit("fleet_ingest", **rec)
    return rec


def phase_fleet_parity(dev) -> dict:
    """``bench_fleet.py``'s ``_parity_transfer`` at full size: 8 tenants
    with simulator executors and cross-tenant transfer, against 8 isolated
    sessions on the same seeded traces."""
    S = FLEET_PARITY_TENANTS
    base = KermitConfig(monitor=MonitorConfig(window_size=FLEET_WINDOW),
                        analysis=AnalysisConfig(interval=24))

    def executor(t):
        return SimulatorExecutor(FLEET_PARITY_SCHED, window_size=FLEET_WINDOW,
                                 seed=t, device=dev)
    seen, analyses = [], []
    with dbscan_inputs(seen), count_calls(A.KermitAnalyser, "run",
                                          analyses):
        reset_counters()
        t0 = time.perf_counter()
        sessions = []
        for s in range(S):
            sess = KermitSession(base, executor=executor(s), device=dev)
            sess.run()
            sessions.append(sess)
        iso_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet = record_ticks(KermitFleet(
            FleetConfig(tenants=S, base=base, transfer=True),
            executors=executor, device=dev))
        fleet.run()
        fleet_s = time.perf_counter() - t0
        launches = counters()

    mism = [f"tenant {s}: window {k}" for s, k in
            tick_mismatches(fleet, sessions)]
    for s, sess in enumerate(sessions):
        if not np.array_equal(sess.monitor.label_log,
                              fleet.ring.ordered(s)[2]):
            mism.append(f"tenant {s}: labels")
        st = sorted(e.window_id for e in sess.events
                    if e.kind == "transition")
        ft = sorted(e.window_id for e in fleet.events
                    if e.kind == "transition" and e.tenant == s)
        if st != ft:
            mism.append(f"tenant {s}: transition windows")
        if sess.current != fleet.current[s]:
            mism.append(f"tenant {s}: committed winner")
        view = fleet.tenant_db(s)
        for label, r in sorted(sess.db.records.items()):
            fr = view.records.get(label)
            if fr is None or (r.config, r.has_optimal) != \
                    (fr.config, fr.has_optimal):
                mism.append(f"tenant {s}: label {label} stored config")
    if mism:
        raise AssertionError("fleet decisions diverged from isolated "
                             "sessions: " + "; ".join(mism[:6]))
    st = fleet.stats
    iso_evals = sum(s.plugin.stats.evaluations for s in sessions)
    fleet_evals = sum(fleet.plugin_stats(t).evaluations for t in range(S))
    assert st.warm_transfers >= 1, vars(st)
    assert st.fleet_evals_saved >= 1, vars(st)
    assert fleet_evals <= iso_evals, (fleet_evals, iso_evals)
    assert len(analyses) == len(seen) > 0, (len(analyses), len(seen))
    if dev.type == "cuda":
        assert launches["nbr_adjacency"] == len(analyses), launches
        assert launches["pairdist"] == launches["flash_attention"] == \
            launches["ssd_scan"] == 0, launches
    for sess in sessions:
        sess.close()
    preds = np.stack([t[2] for t in fleet.ticks_seen])
    assert (preds >= 0).any(), "no tenant's LSTM predicted"
    rec = {"tenants": S, "parity": "bit-equal",
           "predictions_compared": int((preds >= 0).sum()),
           "warm_transfers": st.warm_transfers,
           "fleet_evals_saved": st.fleet_evals_saved,
           "scalar_evaluations": iso_evals, "fleet_evaluations": fleet_evals,
           "analyses": st.analyses, "plans": st.plans,
           "dispatches": st.dispatches, "ticks": st.ticks,
           "analyses_run": len(analyses),
           "kernel_launches": launches["nbr_adjacency"],
           "fleet_s": fleet_s, "isolated_s": iso_s,
           "reference_BENCH_fleet": FLEET_REFERENCE}
    emit("fleet_parity", **rec)
    return {"launches": launches["nbr_adjacency"],
            "parity": check_main_path("fleet_parity", seen, dev)}


def fig10_metrics(labels, gt) -> tuple[float, float]:
    """``bench_clustering.py``'s Awt and purity."""
    mask = labels >= 0
    if mask.sum() == 0:
        return 0.0, 0.0
    purity_n = 0
    for c in np.unique(labels[mask]):
        sub = gt[mask][labels[mask] == c]
        purity_n += np.unique(sub, return_counts=True)[1].max()
    n_true = len(np.unique(gt[gt >= 0]))
    return (1.0 if len(np.unique(labels[mask])) == n_true else 0.0,
            purity_n / mask.sum())


def phase_clustering(dev, n_seeds: int = 6) -> dict:
    """``bench_clustering.py`` (the paper's Fig. 10) through the port on
    the card: DBSCAN, kmeans at the true class count and two above it, and
    single-link over six seeded window series.  The ε-neighbour kernel
    runs once per DBSCAN and once per single-link."""
    seen = []
    algs = {
        "dbscan": lambda x, k: (0.35, 4),
        "kmeans_true_k": lambda x, k: k,
        "kmeans_k_plus2": lambda x, k: k + 2,
        "single_link": lambda x, k: (0.5, 1),
    }
    scores = {a: ([], []) for a in algs}
    kmeans_cpu_equal = True
    reset_counters()
    t0 = time.perf_counter()
    for seed in range(n_seeds):
        sched = random_schedule(6, seed=seed + 10,
                                subset=["dense_train", "decode_serve",
                                        "long_prefill", "moe_train"])
        sim = generate(sched, window_size=24, seed=seed,
                       transition_windows=0)
        gt = sim.window_labels
        x = np.asarray(sim.windows.mean, np.float32)
        k_true = len(np.unique(gt[gt >= 0]))
        for name, arg in algs.items():
            a = arg(x, k_true)
            if name.startswith("kmeans"):
                labels = kmeans(x, a, device=dev)
                kmeans_cpu_equal &= bool(np.array_equal(
                    labels, kmeans(x, a, device="cpu")))
            else:
                labels = (dbscan(x, eps=a[0], min_pts=a[1], device=dev)
                          if name == "dbscan" else
                          agglomerative_single_link(x, a[0], device=dev))
                seen.append((x, a[0], a[1], labels))
            awt, pur = fig10_metrics(np.asarray(labels), gt)
            scores[name][0].append(awt)
            scores[name][1].append(pur)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters()
    assert len(seen) == 2 * n_seeds
    if dev.type == "cuda":
        assert launches["nbr_adjacency"] == len(seen), launches
    rec = {name: {"awt": float(np.mean(a)), "purity": float(np.mean(p))}
           for name, (a, p) in scores.items()}
    emit("clustering", seeds=n_seeds, seconds=seconds,
         kernel_launches=launches["nbr_adjacency"],
         kmeans_labels_equal_cpu=kmeans_cpu_equal, **rec)
    return {"launches": launches["nbr_adjacency"],
            "parity": check_main_path("clustering", seen, dev)}


def release_memory() -> None:
    """Return the memory of engines the caller has dropped."""
    gc.collect()
    torch.cuda.empty_cache()


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

    phase_build()
    timed, timed_ssd, timed_dense, timed_nbr = {}, {}, {}, {}
    for name, fn in (("kernel_nbr", lambda: timed_nbr.update(
                         phase_kernel(dev))),
                     ("kernel_flash", lambda: timed.update(
                         phase_kernel_flash(dev))),
                     ("kernel_ssd", lambda: timed_ssd.update(
                         phase_kernel_ssd(dev))),
                     ("kernel_pairdist", lambda: timed_dense.update(
                         phase_kernel_pairdist(dev)))):
        t0 = time.perf_counter()
        fn()
        emit("phase_seconds", of=name, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    quick_launches, quick, quick_events = phase_quickstart(dev)
    full_launches, full, x_last, full_outcome = phase_full_history(dev)
    # the ε-neighbour kernel timed at the main path's largest input: the
    # last analysis, over the full ring
    x_main = torch.from_numpy(x_last).to(dev)
    main_shape = time_kernel(x_main, 0.35)
    timed_nbr[int(x_main.shape[0])] = main_shape
    emit("phase_seconds", of="quickstart+full_history",
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    qleg_launches, qleg = phase_quickstart_legacy(dev, quick_events)
    emit("phase_seconds", of="quickstart_legacy",
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    hleg_launches, hleg, x_dense = phase_legacy_history(dev, full_outcome)
    emit("phase_seconds", of="legacy_history",
         seconds=time.perf_counter() - t0)
    # the dense kernel timed at the seed path's largest input: the last
    # analysis, over the full ring
    x_dense = torch.from_numpy(x_dense).to(dev)
    dense_shape = time_dense(x_dense)
    timed_dense[int(x_dense.shape[0])] = dense_shape
    release_memory()

    qwen2 = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    eng, served = phase_serving(dev, "serving", qwen2, SERVE_INITIAL,
                                SERVE_SPACE,
                                {"flash_attention": qwen2.n_layers})
    emit("phase_seconds", of="serving", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_serving_parity(dev, eng, "serving_parity", SERVE_INITIAL)
    flash_dev = profile_serve(eng, SERVE_INITIAL,
                              {"flash": "flash_fwd_wgmma"})["flash"]
    emit("phase_seconds", of="serving_parity+profile",
         seconds=time.perf_counter() - t0)
    del eng
    release_memory()

    mamba2 = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    eng, served_ssm = phase_serving(dev, "serving_ssm", mamba2, SSM_INITIAL,
                                    SSM_SPACE, {"ssd_scan": mamba2.n_layers})
    emit("phase_seconds", of="serving_ssm", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_serving_parity(dev, eng, "serving_ssm_parity", SSM_INITIAL)
    ssd_dev = profile_serve(eng, SSM_INITIAL, {"ssd": "ssd_fwd_mma"})["ssd"]
    emit("phase_seconds", of="serving_ssm_parity+profile",
         seconds=time.perf_counter() - t0)
    del eng
    release_memory()

    t0 = time.perf_counter()
    hybrid = phase_hybrid(dev)
    emit("phase_seconds", of="hybrid", seconds=time.perf_counter() - t0)
    release_memory()

    t0 = time.perf_counter()
    trained = phase_training(dev)
    emit("phase_seconds", of="training", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_training_parity(dev, trained)
    emit("phase_seconds", of="training_parity",
         seconds=time.perf_counter() - t0)
    del trained["trainer"], trained["batch"]
    release_memory()
    t0 = time.perf_counter()
    trained_ssm = phase_training_ssm(dev)
    emit("phase_seconds", of="training_ssm",
         seconds=time.perf_counter() - t0)
    release_memory()
    t0 = time.perf_counter()
    phase_fault_tolerance(dev)
    emit("phase_seconds", of="fault_tolerance",
         seconds=time.perf_counter() - t0)
    release_memory()

    t0 = time.perf_counter()
    scen = phase_scenarios(dev)
    emit("phase_seconds", of="scenarios", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    durable = phase_durable_history(dev, full_outcome)
    emit("phase_seconds", of="durable_history",
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_plan_model(dev)
    emit("phase_seconds", of="plan_model", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_fleet_ingest(dev)
    emit("phase_seconds", of="fleet_ingest",
         seconds=time.perf_counter() - t0)
    release_memory()
    t0 = time.perf_counter()
    fleet = phase_fleet_parity(dev)
    emit("phase_seconds", of="fleet_parity",
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    clustering = phase_clustering(dev)
    emit("phase_seconds", of="clustering", seconds=time.perf_counter() - t0)

    main = quick + full + served["nbr_parity"] + served_ssm["nbr_parity"] \
        + trained["nbr_parity"] + scen["parity"] + durable["parity"] \
        + fleet["parity"] + clustering["parity"]
    B, S = MAIN_SHAPE
    fl = timed[MAIN_SHAPE]
    sd = timed_ssd[("mamba2-1.3b", B, S)]
    nbr_by_phase = {"quickstart": quick_launches,
                    "full_history": full_launches,
                    "serving": served["launches"]["nbr_adjacency"],
                    "serving_ssm": served_ssm["launches"]["nbr_adjacency"],
                    "training": trained["launches"]["nbr_adjacency"],
                    "scenarios": scen["launches"],
                    "durable_history": durable["launches"],
                    "fleet_parity": fleet["launches"],
                    "clustering": clustering["launches"]}
    flash_by_phase = {"serving": served["launches"]["flash_attention"],
                      "hybrid": hybrid["launches"]["flash_attention"],
                      "training": trained["launches"]["flash_attention"]}
    flash_parity = served["parity"]["flash_attention"] + \
        hybrid["parity"]["flash_attention"] + trained["parity"]
    ssd_by_phase = {"serving_ssm": served_ssm["launches"]["ssd_scan"],
                    "hybrid": hybrid["launches"]["ssd_scan"],
                    "training_ssm": trained_ssm["launches"]["ssd_scan"]}
    ssd_parity = served_ssm["parity"]["ssd_scan"] + \
        hybrid["parity"]["ssd_scan"] + trained_ssm["parity"]
    print(json.dumps({"kernels": [{
        "name": "nbr_adjacency", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES,
        "launches": sum(nbr_by_phase.values()),
        "launches_by_phase": nbr_by_phase,
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes the counts and "
        "packed adjacency",
        "n": int(x_main.shape[0]), "device_ms": main_shape["device_ms"],
        "timed": {n: summary(rec) for n, rec in sorted(timed_nbr.items())},
        "parity": {"main_path_inputs": len(main),
                   "n": sorted({r["n"] for r in main}),
                   "near_threshold_bits": sum(r["near_threshold_bits"]
                                              for r in main)},
        "tolerance": "counts and bits equal; a bit may differ only where "
                     "the float64 squared distance is within 1e-6·ε² of ε²; "
                     "labels equal"}, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_REPLACES, "launches": sum(flash_by_phase.values()),
        "launches_by_phase": flash_by_phase,
        "max_abs_err": max(flash_parity),
        "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "bound_fp32_ms": fl["bound_fp32_ms"],
        "library_ms": fl["library_ms"], "library": "torch.nn.functional."
        "scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
        "library_device_ms": fl["library_device_ms"],
        "shape": {"B": B, "S": S, **QWEN2, "dtype": "bf16"},
        "device_ms": flash_dev[0],
        "device_ms_zamba2": hybrid["device_ms"]["flash"][0],
        "design": FA.DESIGN,
        "backward": "recompute through models/layers.attention_xla, "
        "differentiated by autograd (FlashAttention, a torch.autograd."
        "Function), as the reference's custom_vjp "
        "(src/repro/kernels/flash_attention.py:143-160)",
        "launches_by_dtype": by_dtype(served["launches"], hybrid["launches"],
                                      trained["launches"],
                                      name="flash_attention"),
        "timed": {("zamba2_B8xS48" if key == "zamba2" else
                   f"B{key[0]}xS{key[1]}"): summary(rec)
                  for key, rec in timed.items()},
        "parity": {"main_path_inputs": len(flash_parity)},
        "tolerance": "|kernel - plain| <= 1e-3 + 2^-7·|plain| in bf16 (one "
                     "bf16 step), 2e-5 + 2e-5·|plain| in fp32"}, {
        "name": "ssd_scan", "route": "cuda", "source": SSD_SRC,
        "replaces": SSD_REPLACES, "launches": sum(ssd_by_phase.values()),
        "launches_by_phase": ssd_by_phase,
        "max_abs_err": max(ssd_parity),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "bound_fp32_ms": sd["bound_fp32_ms"],
        "library_ms": None, "library": "none: no single PyTorch call "
        "computes the SSD scan", "library_device_ms": None,
        "shape": {"B": B, "S": S, "chunk": SSD_CHUNK, **MAMBA2,
                  "dtype": "bf16"},
        "device_ms": ssd_dev[0],
        "device_ms_zamba2": hybrid["device_ms"]["ssd"][0],
        "design": SSD.DESIGN,
        "backward": "recompute through models/mamba2.ssd_chunked (y cast "
        "to fp32), differentiated by autograd (SSDScan, a torch.autograd."
        "Function), as the reference's custom_vjp "
        "(src/repro/kernels/ssd_scan.py:115-136)",
        "launches_by_dtype": by_dtype(served_ssm["launches"],
                                      hybrid["launches"],
                                      trained_ssm["launches"],
                                      name="ssd_scan"),
        "timed": {("zamba2_B8xS48" if name == "zamba2-7b" else
                   f"B{b}xS{s_}"): summary(rec)
                  for (name, b, s_), rec in timed_ssd.items()},
        "parity": {"main_path_inputs": len(ssd_parity)},
        "tolerance": "|kernel - plain| <= 1e-4 + 1e-4·|plain| for y and the "
                     "state (fp32 outputs, bf16 or fp32 inputs)"}, {
        "name": "pairdist", "route": "cuda", "source": DENSE_SRC,
        "replaces": DENSE_REPLACES, "launches": qleg_launches + hleg_launches,
        "launches_by_phase": {"quickstart_legacy": qleg_launches,
                              "legacy_history": hleg_launches},
        "max_abs_err": max(r["max_abs_err"] for r in qleg + hleg),
        "ms": dense_shape["ms"], "plain_ms": dense_shape["plain_ms"],
        "bound_ms": dense_shape["bound_ms"],
        "bound_by": dense_shape["bound_by"],
        "library_ms": dense_shape["library_ms"],
        "library": "torch.cdist(x, x).square()",
        "library_device_ms": dense_shape["library_device_ms"],
        "n": int(x_dense.shape[0]), "device_ms": dense_shape["device_ms"],
        "device_ms_l2_flushed": dense_shape["device_ms_l2_flushed"],
        "timed": {n: summary(rec) for n, rec in sorted(
            (k, v) for k, v in timed_dense.items() if k != "max_abs_err")},
        "parity": {"main_path_inputs": len(qleg + hleg),
                   "n": sorted({r["n"] for r in qleg + hleg}),
                   "sweep_max_abs_err": timed_dense["max_abs_err"],
                   "threshold_equals_nbr_bits": True,
                   "legacy_labels_equal_fast": True},
        "tolerance": "|kernel - plain| <= 1e-5·(|x_i|² + |x_j|²) + 1e-6 "
                     "per entry; d2 <= ε² equal to the ε-neighbour kernel's "
                     "bits"}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
