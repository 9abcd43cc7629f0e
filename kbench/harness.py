"""One run of one cell: KERMIT tuning a live server of the cell's model
under the cell's traffic, for ``seconds``, with the benchmark's spans
around the calls into the program.

Set-up builds the ``ServeEngine`` at the configuration's widths, hands
it weights and prompt tokens made from the seed (``weights``), and warms
every (batch, prompt bucket, capacity) shape that the plan space and the
mix can produce with one untimed ``serve`` each.  The window then drives
``run_serving_session(session, executor)`` and closes at the first
committed-window boundary after ``seconds``.

Spans (host clock, ``time.perf_counter``) wrap, from outside the
program: every ``ServeEngine.serve`` (its prefill's end marked after a
synchronize, which the engine makes there anyway), every committed
window (``ServeExecutor.serve_window``), every trial
(``measure``/``measure_batch``) and every analysis
(``KermitAnalyser.run``); the DBSCAN calls of the analyses are recorded
with their points and labels.  Which engine call served which chunk of a
committed window is worked out afterwards from the window itself, by
``replay``'s frozen copy of the executor's chunking.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from kbench import check, profiling, replay, traffic, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# measured committed calls traced in a --trace 1 run, and at most this many
# engine calls of committed windows traced in all
TRACED_MEASURED, TRACED_MAX = 3, 6
SCHEDULE_WINDOWS = 2000


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(root: Path, workload: str) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    per_layer = [p for p in bench["per_layer"]
                 if workload in p.get("workloads", [workload])]
    return {"bench": bench, "cell": cell, "config": cfg,
            "mix": traffic.load_mix(root, cell["traffic"]),
            "per_layer": per_layer}


def load_reader(root: Path, name: str):
    """``kbench/metrics/<name>.py``'s ``read``."""
    path = root / "kbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"kbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_config(cfg: dict, family):
    """The program's ``ModelConfig`` named by the file (``program.arch``,
    with ``program.replace``'s fields changed, where a test runs it
    small), held to the file's sizes as the family's module reads them."""
    from repro_torch.configs.registry import get_config
    prog = cfg["program"]
    pc = get_config(prog["arch"])
    rep = dict(prog.get("replace", {}))
    if "ssm" in rep:
        rep["ssm"] = dataclasses.replace(pc.ssm, **rep["ssm"])
    pc = pc.replace(**rep)
    got = {**family.program_sizes(pc), "dtype": pc.dtype}
    want = {**family.dims(cfg), "dtype": cfg["torch_dtype"]}
    if got != want:
        raise RuntimeError(f"the program's {prog['arch']} is not the "
                           f"configuration file's: {got} != {want}")
    return pc


def space_tunables(initial, space: dict) -> list:
    """Every candidate of the plan space, as Tunables."""
    combos = [{}]
    for knob, values in space.items():
        combos = [{**c, knob: v} for c in combos for v in values]
    return [initial.replace(**c) for c in combos]


class Recorder:
    """Spans and records of one window, filled by the wrappers."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.ctx = "setup"
        self.calls: list = []
        self.windows: list = []
        self.trials: list = []
        self.analyses: list = []
        self.dbscan: list = []
        self.trace = False
        self.traced_measured = 0
        self.traced_calls = 0
        self.profiler_s = 0.0
        self.window_index = -1

    def want_trace(self) -> bool:
        return (self.trace and self.ctx == "committed"
                and self.window_index >= 1
                and self.traced_measured < TRACED_MEASURED
                and self.traced_calls < TRACED_MAX)


class Bench:
    """One cell's system under test, built once per process."""

    def __init__(self, root: Path, workload: str, device: str = "cuda"):
        from repro_torch.configs.base import Tunables
        from repro_torch.kermit import ServeEngine
        self.root = Path(root)
        self.workload = workload
        spec = load_cell(self.root, workload)
        self.cell, self.cfg, self.mix = spec["cell"], spec["config"], \
            spec["mix"]
        self.per_layer = spec["per_layer"]
        self.end_to_end = [e for e in spec["bench"]["end_to_end"]
                           if workload in e.get("workloads", [workload])]
        self.ref = importlib.import_module(
            f"kbench.reference.{self.cfg['model_type']}")
        self.m = self.ref.dims(self.cfg)
        self.pcfg = program_config(self.cfg, self.ref)
        k = self.cfg["kermit"]
        self.initial = Tunables(**k["initial"])
        self.space = k["plan"]["space"]
        self.device = torch.device(device)
        self.dtype = getattr(torch, self.cfg["torch_dtype"])
        self.engine = ServeEngine(self.pcfg, seed=0, initial=self.initial,
                                  device=device)
        self.rec = Recorder()
        self._wrap_engine()

    # -- set-up --------------------------------------------------------------

    def shapes(self) -> list:
        """(tunables, batch, prompt) of every shape the plan space and the
        mix can produce."""
        tuns = space_tunables(self.initial, self.space)
        if self.initial not in tuns:
            tuns.append(self.initial)
        return [(t, int(t.serve_batch), int(P)) for t in tuns
                for P in self.mix["prompt"]["buckets"]]

    def prepare(self, seed: int, warm: bool = True) -> None:
        """Weights and prompt tokens from ``seed``, handed to the engine;
        then (``warm``) one untimed serve per shape."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.weights = weights.make_weights(
            self.ref.leaves(self.m, self.dtype), gen)
        weights.install(self.engine, self.weights)
        shapes = self.shapes()
        self.prompts = weights.make_tokens(
            self.m["vocab"], {(P, B) for _, B, P in shapes}, gen)
        self.engine._batches = {k: {"tokens": v}
                                for k, v in self.prompts.items()}
        for tun, B, P in shapes if warm else ():
            self.engine.serve(batch=B, prompt_len=P, gen=1, tunables=tun)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the wrappers ----------------------------------------------------------

    def _wrap_engine(self) -> None:
        eng, rec = self.engine, self.rec
        real_serve, real_prefill = eng.serve, eng.prefill_step

        def serve(*a, **kw):
            c = {"ctx": rec.ctx, "window": rec.window_index,
                 "batch": int(kw["batch"]), "prompt": int(kw["prompt_len"]),
                 "gen": np.broadcast_to(np.asarray(kw["gen"], np.int64),
                                        (int(kw["batch"]),)).copy(),
                 "tunables": kw.get("tunables"), "trace": None}
            rec.calls.append(c)

            def timed():
                c["t0"] = time.perf_counter()
                out = real_serve(*a, **kw)
                c["t1"] = time.perf_counter()
                return out
            if rec.want_trace():
                rec.traced_calls += 1
                lead = profiling.PROFILE_LEADS_S[
                    (rec.traced_calls - 1) % len(profiling.PROFILE_LEADS_S)]
                t = time.perf_counter()
                rep, c["trace"] = profiling.traced(timed, lead)
                rec.profiler_s += time.perf_counter() - t - (c["t1"] - c["t0"])
            else:
                rep = timed()
            c["steps"], c["generated"] = int(rep.steps), rep.generated
            return rep

        def prefill_step(tun):
            fn = real_prefill(tun)

            def timed(*a, **kw):
                out = fn(*a, **kw)
                self._sync()
                rec.calls[-1]["tp"] = time.perf_counter()
                return out
            return timed
        eng.serve, eng.prefill_step = serve, prefill_step

    def _wrap_dbscan(self):
        """Record the analyser's DBSCAN calls; returns the function to put
        back once the window has closed."""
        from repro_torch.core import analyser as A
        real, rec = A.dbscan, self.rec

        def dbscan(x, eps, min_pts=5, *a, **kw):
            labels = real(x, eps, min_pts, *a, **kw)
            pts = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
            rec.dbscan.append((np.array(pts, np.float32), float(eps),
                               int(min_pts), np.array(labels)))
            return labels
        A.dbscan = dbscan
        return real

    def _wrap_session(self, ex, session) -> None:
        rec = self.rec
        real_window, real_measure = ex.serve_window, ex.measure
        real_batch, real_run = ex.measure_batch, session.analyser.run

        def serve_window(win):
            rec.window_index += 1
            w = {"win": win, "tun": ex.current, "first": len(rec.calls),
                 "t0": time.perf_counter()}
            rec.ctx = "committed"
            try:
                return real_window(win)
            finally:
                rec.ctx = "window"
                w["t1"], w["last"] = time.perf_counter(), len(rec.calls)
                rec.windows.append(w)
                replay.mark_window(rec.calls, w)
                rec.traced_measured += sum(
                    1 for c in rec.calls[w["first"]:w["last"]]
                    if c["trace"] is not None and c.get("measured"))

        def spanned(real):
            def run(*a, **kw):
                rec.ctx = "trial"
                t0 = time.perf_counter()
                try:
                    return real(*a, **kw)
                finally:
                    rec.trials.append((t0, time.perf_counter()))
                    rec.ctx = "window"
            return run

        def analyse(*a, **kw):
            t0 = time.perf_counter()
            rep = real_run(*a, **kw)
            rec.analyses.append((t0, time.perf_counter(),
                                 float(rep.analysis_seconds)))
            return rep
        ex.serve_window = serve_window
        ex.measure, ex.measure_batch = spanned(real_measure), \
            spanned(real_batch)
        session.analyser.run = analyse

    # -- the window ------------------------------------------------------------

    def session(self, seed: int):
        from repro_torch.kermit import (AnalysisConfig, KermitConfig,
                                        KermitSession, KnowledgeConfig,
                                        MonitorConfig, PlanConfig,
                                        ServeConfig, ServeExecutor)
        k = self.cfg["kermit"]
        kcfg = KermitConfig(
            monitor=MonitorConfig(**k["monitor"]),
            analysis=AnalysisConfig(**k["analysis"]),
            knowledge=KnowledgeConfig(**k["knowledge"]),
            plan=PlanConfig(space=self.space,
                            default_tunables=self.initial.as_dict()))
        tr = traffic.Traffic(self.mix, seed, SCHEDULE_WINDOWS)
        ex = ServeExecutor(self.engine, tr, config=ServeConfig(
            window_size=tr.window_size, **k["serve"]), initial=self.initial)
        return ex, KermitSession(kcfg, executor=ex, device=self.device)

    def run(self, seed: int, seconds: float, trace: bool) -> dict:
        """The measured window; returns the record the metrics read."""
        from repro_torch.kermit import run_serving_session
        rec = self.rec
        rec.reset()
        rec.trace = trace and self.device.type == "cuda"
        ex, session = self.session(seed)
        self._wrap_session(ex, session)
        stream = ex.telemetry_stream

        def bounded():
            # a traced run's window holds an untraced one's work: the
            # time its profiler takes is added to the deadline
            for rows in stream():
                yield rows
                if time.perf_counter() >= deadline + rec.profiler_s:
                    return
        ex.telemetry_stream = bounded
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        rec.ctx = "window"
        real_dbscan = self._wrap_dbscan()
        try:
            with session:
                t0 = time.perf_counter()
                deadline = t0 + float(seconds)
                run_serving_session(session, ex)
                self._sync()
                t1 = time.perf_counter()
        finally:
            from repro_torch.core import analyser
            analyser.dbscan = real_dbscan
        rec.ctx = "after"
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        calibrated, _ = replay.unit_from_spans(rec, self.initial)
        unit = check.cell_file(self.root, self.workload).get("unit_s")
        return {"rec": rec, "t0": t0, "t1": t1,
                "peak": peak, "unit": unit or calibrated,
                "calibrated_unit": calibrated, "program_unit": ex._unit,
                "latencies": replay.latencies(rec, unit or calibrated),
                "program_latencies": np.asarray(ex.request_latencies,
                                                np.float64),
                "events": [(e.window_id, e.kind) for e in session.events],
                "final": ex.current}


# -- from a window to the result line -------------------------------------


def view(bench: Bench, out: dict) -> dict:
    """What the metric readers read: the window's spans, its measured
    committed calls (traced ones apart) and its complete traces."""
    rec = out["rec"]
    committed = [c for c in rec.calls if c["ctx"] == "committed"]
    measured = [c for c in committed if c.get("measured")]
    traces = []
    for c in measured:
        if c["trace"] is not None and c["trace"]["complete"]:
            traces.append({**c["trace"], "batch": c["batch"],
                           "prompt": c["prompt"],
                           "wall_s": c["t1"] - c["t0"]})
    return {
        "model": bench.m, "chunk": int(bench.initial.ssm_chunk),
        "call_flops": bench.ref.call_flops,
        "wall_s": out["t1"] - out["t0"] - rec.profiler_s,
        "measured": [c for c in measured if c["trace"] is None],
        "engine_s": sum(c["t1"] - c["t0"] for c in committed),
        "trial_s": sum(b - a for a, b in rec.trials),
        "analyses": [s for _, _, s in rec.analyses],
        "analysis_span_s": sum(b - a for a, b, _ in rec.analyses),
        "traces": traces,
    }


def breakdown(traces: list) -> dict:
    """The device operations that took most time in the traced calls, and
    the longest idle gaps, named by the part of the call the host was in
    (before the last attention or scan launch: the prefill)."""
    per, gaps = {}, {}
    for t in traces:
        ops = t["ops"]
        for n, b, e in ops:
            per[n[:96]] = per.get(n[:96], 0.0) + (e - b) / 1e6
        last = max((i for i, (n, _, _) in enumerate(ops)
                    if "flash_fwd" in n or "ssd_fwd" in n), default=-1)
        for i in range(1, len(ops)):
            gap = (ops[i][1] - ops[i - 1][2]) / 1e6
            if gap > 0:
                part = ("prefill: host between launches" if i <= last else
                        "decode: host between launches")
                gaps[part] = gaps.get(part, 0.0) + gap
        if ops:
            lost = t["wall_s"] - (ops[-1][2] - ops[0][1]) / 1e6
            gaps["call: host before the first and after the last launch"] = \
                gaps.get("call: host before the first and after the last "
                         "launch", 0.0) + max(lost, 0.0)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}


def verdict(gap: float, db: dict, compared: int, limits: dict,
            min_discoveries: int = 1) -> tuple:
    """Each number compared beside its limit, and whether all hold."""
    checks = {
        "logit_gap": {"value": gap, "limit": limits.get("logit_gap")},
        "dbscan_mismatches": {"value": db["mismatches"], "limit": 0},
        "dbscan_discoveries": {"value": db["discoveries"],
                               "limit": min_discoveries},
        "served_tokens_compared": {"value": compared, "limit": 1},
    }
    ok = (limits.get("logit_gap") is not None
          and gap <= limits["logit_gap"] and db["mismatches"] == 0
          and db["discoveries"] >= min_discoveries and compared >= 1)
    return bool(ok), checks


def correctness(bench: Bench, out: dict, seed: int, control: bool = False,
                min_discoveries: int = 1) -> dict:
    """The served tokens against the reference, the DBSCAN labels against
    the plain DBSCAN, each number beside its limit.  With ``control``,
    also the control's verdict by the same limits: its first-ranked
    tokens' gaps in the served tokens' place.  A window too short to
    reach an analysis (``calibrate.py``'s) asks for no discovery."""
    rec = out["rec"]
    measured = [c for c in rec.calls if c.get("measured")]
    picked = check.sample(check.served_requests(measured), seed)
    gaps = check.served_gaps(bench.ref, bench.weights, bench.m,
                             bench.prompts, picked, control=control)
    db = check.dbscan_mismatches(rec.dbscan)
    limits = check.cell_file(bench.root, bench.workload)
    compared = int(sum(len(r["served"]) for r in picked))
    ok, checks = verdict(max(gaps["served"], default=float("nan")), db,
                         compared, limits, min_discoveries)
    res = {"correct": ok, "checks": checks, "gaps": gaps, "dbscan": db,
           "requests_compared": len(picked)}
    if control:
        res["control_correct"], res["control_checks"] = verdict(
            max(gaps["control"], default=float("nan")), db, compared, limits,
            min_discoveries)
    return res


def measure(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, t_start: float, device: str = "cuda",
            log=print) -> dict | None:
    """One run: set-up, the window, the check; the result line's object,
    or None when the run may print no result."""
    bench = Bench(root, workload, device)
    if bench.device.type == "cuda":
        from repro_torch.kernels import cuda_build
        cuda_build.build("nbr_adjacency", "flash_attention"
                         if bench.m["family"] == "dense" else "ssd_scan")
    bench.prepare(seed)
    setup_s = time.perf_counter() - t_start
    out = bench.run(seed, seconds, trace)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return None
    rec = out["rec"]
    for c in rec.calls:
        if c["trace"] is not None:
            c["trace"] = profiling.read(c["trace"])
    v = view(bench, out)
    traces = v["traces"]
    if trace:
        log(json.dumps({"traced_calls": [
            {"measured": bool(c.get("measured")), "complete":
             c["trace"]["complete"], "seen": c["trace"]["seen"],
             "expected": c["trace"]["expected"], "lead_s":
             c["trace"]["lead_s"]} for c in rec.calls
            if c["trace"] is not None]}), file=sys.stderr)
    committed = [c for c in rec.calls if c.get("measured")]
    attempted = int(sum(c["real_rows"] for c in committed))
    tokens = replay.served_tokens(committed)
    lat = out["latencies"]
    metrics = {}
    if not trace:
        values = {"request_p95_s": (replay.p95_nearest_rank(lat), "s"),
                  "served_tokens_per_s": (tokens / v["wall_s"],
                                          "tokens/s"),
                  "setup_s": (setup_s, "s")}
        for e in bench.end_to_end:
            val, unit = values[e["name"]]
            metrics[e["name"]] = {"value": val, "unit": unit}
    else:
        for p in bench.per_layer:
            val = load_reader(bench.root, p["name"])(v)
            if val is not None:
                metrics[p["name"]] = {"value": val, "unit": p["unit"]}
    prog = out["program_latencies"]
    log(json.dumps({
        "setup_s": setup_s, "window_s": v["wall_s"],
        "committed_windows": len(rec.windows),
        "committed_requests": attempted, "served_tokens": tokens,
        "unit_s": out["unit"],
        "calibrated_unit_s": out["calibrated_unit"],
        "program_unit_s": out["program_unit"],
        "phases": sorted({w["win"].phase for w in rec.windows}),
        "analyses": len(rec.analyses), "trials": len(rec.trials),
        "engine_calls": len(rec.calls),
        "p95_program_latencies_s": (replay.p95_nearest_rank(prog)
                                    if len(prog) else None),
        "latency_rel_diff_max": (float(np.max(np.abs(lat - prog) / prog))
                                 if len(prog) == len(lat) and len(lat)
                                 else None),
        "final_tunables": {k: getattr(out["final"], k)
                           for k in bench.space},
        "events": out["events"],
        # per committed call: ctx, batch, prompt, steps, prefill s, decode s
        "calls": [[c["ctx"][0], c["batch"], c["prompt"], c["steps"],
                   round(c["tp"] - c["t0"], 4), round(c["t1"] - c["tp"], 4)]
                  for c in rec.calls if c["ctx"] in ("committed", "trial")]}),
        file=sys.stderr)
    del out["rec"]
    if bench.device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = correctness(bench, {"rec": rec}, seed)
    log(json.dumps({"requests_compared": verdict["requests_compared"],
                    "gaps": verdict["gaps"]["served"],
                    "dbscan": verdict["dbscan"]}), file=sys.stderr)
    for name, c in verdict["checks"].items():
        log(f"check {name}: {c['value']} limit {c['limit']}",
            file=sys.stderr)
    dev = {"platform": "gpu" if bench.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(bench.device)
                    if bench.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = sum(t["busy_s"] for t in traces)
        dev["window_s"] = sum(t["wall_s"] for t in traces)
        result["breakdown"] = breakdown(traces)
    result["checks"] = verdict["checks"]
    return result
