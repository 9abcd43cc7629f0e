"""Scenario runner: manifest -> fault-injected sessions -> results/<RUN_ID>/.

Port of ``repro/scenarios/runner.py``.  It reads the port's own copy of the
manifest (``repro_torch/scenarios/manifest.json``, byte-equal to the
reference's) and runs every scenario on one device (``device=None``: CUDA;
``--device cpu`` on the command line).  The kinds ``session``, ``crash``,
``serving`` and ``fleet`` are ported.  ``elastic`` and ``elastic_session``
wait for the distribution slice (ROADMAP A7): a run that names one of them
raises ``NotImplementedError`` before any scenario starts, so it is never
counted as passed or skipped.

Each scenario in ``manifest.json`` declares a simulated workload schedule, a
fault schedule (``repro_torch.kermit.chaos`` specs), an optional resilience
policy and a set of *gates* — predicates over the run's metrics that turn the
paper's "without human intervention" claim into pass/fail data:

  min_recovery_ratio    last RECOVERY event's throughput ratio >= bound and
                        flagged recovered (the self-healing tentpole gate)
  require_events        these typed event kinds were emitted
  min_retunes           the loop committed at least this many retunes
  min_known_workloads   discovery found at least this many real classes
  winner_matches_clean  final committed Tunables equal a fault-free rerun's
                        (graceful degradation, not silent corruption)
  knob_pinned           the *applied* config holds the stuck knob's value
  bitwise_decisions     a killed-and-restored supervised run decided
                        identically to an uninterrupted one (labels,
                        committed winners, event stream)
  min_restores          the supervisor actually survived this many deaths
  min_checkpoints       ... and took this many snapshots doing it
  min_warm_started      a fleet tenant's search was warm-started from a
                        class another tenant discovered and tuned
  min_fleet_evals_saved ... and those transfers saved evaluations
  min_evals_saved_vs_isolated  the fleet spent fewer evaluations than S
                        isolated sessions on the same traces
  (the elastic kinds' gates come with those kinds)

Every run writes ``<scenario>--seed<k>--<impl>.json`` (schema-versioned,
self-describing: seed + scenario spec + impl recorded) under
``results/<RUN_ID>/`` plus a ``summary.json`` index and a ``LATEST``
pointer, so the artifact trajectory is a queryable history
(``scripts/check_regression.py`` reads the same shape).  Artifacts also
record the ``device`` they ran on.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.kermit import (AnalysisConfig, ChaosExecutor, CrashFault,
                                EventKind, ExecConfig, FleetConfig,
                                KermitConfig, KermitFleet, KermitSession,
                                KermitSupervisor,
                                KnowledgeConfig, MonitorConfig, PlanConfig,
                                ResilientExecutor, SimulatorExecutor,
                                fault_from_dict)
from repro_torch.kernels.dispatch import resolve_device

SCHEMA_VERSION = 1
DEFAULT_MANIFEST = Path(__file__).with_name("manifest.json")


def load_manifest(path=None) -> dict:
    with open(path or DEFAULT_MANIFEST) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# scenario kinds
# ---------------------------------------------------------------------------


def _build_stack(spec: dict, *, seed: int, device, extra_faults=()):
    """The simulator + chaos (+ resilience) executor stack a scenario spec
    declares; returns (outer executor, the chaos layer).  ``extra_faults``
    are appended *after* the manifest's — a ``CrashFault`` added last leaves
    every other fault's index (and hence its seeded draws) unchanged, so a
    crashing run perturbs identically to a crash-free one."""
    ws = int(spec.get("window_size", 16))
    sim = SimulatorExecutor([tuple(s) for s in spec["schedule"]],
                            window_size=ws, seed=seed,
                            drift=float(spec.get("drift", 0.0)),
                            device=device)
    faults = [fault_from_dict(f) for f in spec.get("faults", [])]
    faults += list(extra_faults)
    chaos = ChaosExecutor(sim, faults, seed=seed, window_size=ws)
    res_cfg = spec.get("resilient")
    ex = ResilientExecutor(chaos, **res_cfg) if res_cfg is not None else chaos
    return ex, chaos


def _build_config(spec: dict, impl: str) -> KermitConfig:
    ws = int(spec.get("window_size", 16))
    return KermitConfig(
        monitor=MonitorConfig(window_size=ws, **spec.get("monitor", {})),
        analysis=AnalysisConfig(**spec.get("analysis", {})),
        plan=PlanConfig(space=spec.get("space"), **spec.get("plan", {})),
        knowledge=KnowledgeConfig(**spec.get("knowledge", {})),
        execute=ExecConfig(**spec.get("execute", {})),
        impl=impl)


def _session_metrics(events, summary: dict, final: dict, chaos,
                     ex) -> dict:
    """The common metrics dict every session-driving scenario reports."""
    by_kind = Counter(e.kind for e in events)
    recoveries = [e.detail for e in events
                  if e.kind == EventKind.RECOVERY.value]
    last = recoveries[-1] if recoveries else None
    return {
        "windows": summary["windows"],
        "events": {k: int(v) for k, v in sorted(by_kind.items())},
        "retunes": int(by_kind.get(EventKind.RETUNE.value, 0)),
        "faults_injected": dict(chaos.injected),
        "recovery_ratio": last["throughput_ratio"] if last else None,
        "recovered": bool(last and last["recovered"]),
        "recovery_attempts": len(recoveries),
        "known_workloads": summary["known_workloads"],
        "searches": int(summary["plugin"]["global_searches"]
                        + summary["plugin"]["local_searches"]),
        "reused": summary["plugin"]["reused"],
        "evaluations": summary["plugin"]["evaluations"],
        "failed_searches": summary["plugin"]["failed_searches"],
        "retries": int(getattr(ex, "retries", 0)),
        "fallbacks": int(getattr(ex, "fallbacks", 0)),
        "final_tunables": final,
        "applied_tunables": chaos.current.as_dict(),
    }


def _run_session_scenario(spec: dict, *, seed: int, impl: str,
                          device) -> dict:
    """Drive a full MAPE-K session over a simulated stream with faults
    injected at the Execute boundary; returns the metrics dict."""
    ws = int(spec.get("window_size", 16))
    ex, chaos = _build_stack(spec, seed=seed, device=device)
    cfg = _build_config(spec, impl)
    events = []
    with KermitSession(cfg, executor=ex, device=device) as session:
        session.subscribe(None, events.append)
        samples = chaos.samples
        hyb = spec.get("hybrid")
        if hyb:
            from repro_torch.core.simulator import generate_hybrid
            samples = np.concatenate([samples, generate_hybrid(
                tuple(hyb["names"]), n_windows=int(hyb.get("n_windows", 8)),
                window_size=ws, seed=seed)])
        session.run(samples)
        summary = session.summary()
        final = session.current.as_dict()
    return _session_metrics(events, summary, final, chaos, ex)


def _decisions(session) -> dict:
    """Everything the loop *decided*, in order — the kill-and-restore gate
    compares this between a crashed-and-restored run and an uninterrupted
    one.  RESTORE events are the recovery mechanism's own trace, not a
    decision, and are excluded."""
    events = [e for e in session.events
              if e.kind != EventKind.RESTORE.value]
    return {
        "events": [(e.window_id, e.kind) for e in events],
        "labels": [(e.window_id, e.label) for e in events],
        "winners": [e.tunables for e in events
                    if e.kind == EventKind.RETUNE.value],
        "final_tunables": session.current.as_dict(),
    }


def _run_crash_restore_scenario(spec: dict, *, seed: int, impl: str,
                                device) -> dict:
    """Kill-and-restore determinism: the same supervised run twice — once
    uninterrupted, once with injected manager crashes (``CrashFault``) that
    the ``KermitSupervisor`` survives by restoring the latest checkpoint —
    gated on bit-identical decisions between the two."""
    import tempfile

    cfg = _build_config(spec, impl)
    crash_windows = [int(w) for w in spec.get("crash_at_windows", [])]

    def factory(crashes):
        def build():
            extra = [CrashFault(at_window=w) for w in crashes]
            ex, _ = _build_stack(spec, seed=seed, device=device,
                                 extra_faults=extra)
            return ex
        return build

    with tempfile.TemporaryDirectory() as tmp:
        clean = KermitSupervisor(cfg, factory([]),
                                 checkpoint_path=Path(tmp) / "clean.npz",
                                 device=device)
        clean.run()
        crashed = KermitSupervisor(cfg, factory(crash_windows),
                                   checkpoint_path=Path(tmp) / "crash.npz",
                                   device=device)
        report = crashed.run()

    session, ex = crashed.session, crashed.session.executor
    chaos = ex
    while chaos is not None and not isinstance(chaos, ChaosExecutor):
        chaos = chaos.__dict__.get("inner")
    metrics = _session_metrics(list(session.events), session.summary(),
                               session.current.as_dict(), chaos, ex)
    metrics.update({
        "restores": report["restores"],
        "checkpoints": report["checkpoints"],
        "crashes": report["crashes"],
        "decisions_match": _decisions(session) == _decisions(clean.session),
    })
    return metrics


def _build_traffic(spec: dict, *, window_size: int, seed: int):
    """The seeded traffic trace a serving scenario declares: either a canned
    shape (``diurnal`` / ``bursty`` / ``kway``) with its keyword overrides,
    or an explicit ``phases`` list of TrafficPhase fields."""
    from repro_torch.kermit.serving import TrafficGenerator, TrafficPhase

    tspec = dict(spec.get("traffic", {"shape": "diurnal"}))
    shape = tspec.pop("shape", "diurnal")
    if shape == "phases":
        phases = [TrafficPhase(**{**p, "tenants": tuple(p.get(
            "tenants", ("chat",)))}) for p in tspec["phases"]]
        return TrafficGenerator(phases, window_size=window_size, seed=seed)
    factory = getattr(TrafficGenerator, shape, None)
    if factory is None:
        raise ValueError(f"unknown traffic shape {shape!r}")
    return factory(window_size=window_size, seed=seed, **tspec)


def _run_serving_scenario(spec: dict, *, seed: int, impl: str,
                          device) -> dict:
    """Close the MAPE-K loop around the *real* inference stack: a
    ``ServeExecutor`` replays a drifting traffic trace against a live
    ``ServeEngine``; the gates check that the traffic phase change triggered
    an autonomous re-plan and that tail latency improved, with zero human
    calls (the runner never applies or invalidates anything by hand)."""
    from repro_torch.configs.base import Tunables
    from repro_torch.kermit.serving import (ServeConfig, ServeExecutor,
                                            run_serving_session)

    ws = int(spec.get("window_size", 8))
    sc = ServeConfig(window_size=ws, **spec.get("serve", {}))
    traffic = _build_traffic(spec, window_size=ws, seed=seed)
    initial = Tunables(**(spec.get("plan", {}).get("default_tunables") or {}))
    ex = ServeExecutor.from_config(sc, traffic, initial=initial,
                                   device=device)
    cfg = _build_config(spec, impl)
    events = []
    with KermitSession(cfg, executor=ex, device=device) as session:
        session.subscribe(None, events.append)
        run_serving_session(session, ex)
        summary = session.summary()
        final = session.current.as_dict()
    return _serving_metrics(events, summary, final, ex)


def _serving_metrics(events, summary: dict, final: dict, ex) -> dict:
    """Serving-scenario metrics: the committed window log is ground truth —
    a re-plan is visible as the applied configuration changing between
    consecutive committed windows."""
    by_kind = Counter(e.kind for e in events)
    wl = ex.window_log
    boundaries = ex.traffic.phase_boundaries()
    change_w = boundaries[0] if boundaries else None
    changes = [wl[i]["window"] for i in range(1, len(wl))
               if wl[i]["tunables"] != wl[i - 1]["tunables"]]
    replans_after = [w for w in changes
                     if change_w is not None and w >= change_w]
    p99_before = p99_after = p99_ratio = tok_s = None
    if replans_after:
        w0 = replans_after[0]
        stale = [w["p99"] for w in wl if change_w <= w["window"] < w0]
        tuned = [w["p99"] for w in wl if w["window"] >= w0]
        if stale and tuned:
            p99_before = float(np.median(stale))
            p99_after = float(np.median(tuned))
            p99_ratio = p99_after / p99_before if p99_before > 0 else None
        tok_s = float(np.median([w["tokens_per_s"] for w in wl
                                 if w["window"] >= w0]))
    return {
        "windows": summary["windows"],
        "events": {k: int(v) for k, v in sorted(by_kind.items())},
        "retunes": int(by_kind.get(EventKind.RETUNE.value, 0)),
        "known_workloads": summary["known_workloads"],
        "searches": int(summary["plugin"]["global_searches"]
                        + summary["plugin"]["local_searches"]),
        "reused": summary["plugin"]["reused"],
        "evaluations": summary["plugin"]["evaluations"],
        "failed_searches": summary["plugin"]["failed_searches"],
        "phase_change_window": change_w,
        "config_change_windows": changes,
        "replans_after_change": len(replans_after),
        "p99_before_replan": p99_before,
        "p99_after_replan": p99_after,
        "p99_ratio": p99_ratio,
        "tokens_per_s_tuned": tok_s,
        # the loop runs unattended end to end: nothing outside the session
        # ever calls apply()/invalidate() — the paper's "without human
        # intervention" claim as a checkable artifact field
        "human_calls": 0,
        "recovery_ratio": None,
        "final_tunables": final,
        "applied_tunables": ex.current.as_dict(),
    }


def _run_fleet_scenario(spec: dict, *, seed: int, impl: str,
                        device) -> dict:
    """Fleet-scale MAPE-K with cross-tenant warm-start transfer: S tenants
    with overlapping workload classes run through ONE ``KermitFleet``
    (shared knowledge base, tenant-tagged records).  The gates check that at
    least one tenant's search was warm-started from a class another tenant
    discovered and tuned, and that the transfer actually saved evaluation
    work versus S isolated sessions on the same traces."""
    ws = int(spec.get("window_size", 16))
    S = int(spec.get("tenants", 2))
    sched = [tuple(s) for s in spec["schedule"]]
    base = _build_config(spec, impl)

    def make_executor(t):
        return SimulatorExecutor(sched, window_size=ws, seed=seed + t,
                                 drift=float(spec.get("drift", 0.0)),
                                 device=device)

    fleet = KermitFleet(
        FleetConfig(tenants=S, base=base,
                    transfer=bool(spec.get("transfer", True))),
        executors=make_executor, device=device)
    events = []
    fleet.subscribe(None, events.append)
    fleet.run()
    summary = fleet.summary()

    # the external check on the transfer win: the same S streams through S
    # isolated sessions (private DBs, no transfer possible)
    isolated_evals = 0
    for t in range(S):
        with KermitSession(base, executor=make_executor(t),
                           device=device) as sess:
            sess.run()
            isolated_evals += sess.plugin.stats.evaluations

    by_kind = Counter(e.kind for e in events)
    st = fleet.stats
    return {
        "windows": summary["windows"],
        "tenants": S,
        "events": {k: int(v) for k, v in sorted(by_kind.items())},
        "retunes": int(by_kind.get(EventKind.RETUNE.value, 0)),
        "known_workloads": summary["known_workloads"],
        "searches": int(summary["plugin"]["global_searches"]
                        + summary["plugin"]["local_searches"]),
        "reused": summary["plugin"]["reused"],
        "evaluations": summary["plugin"]["evaluations"],
        "failed_searches": summary["plugin"]["failed_searches"],
        "monitor_dispatches": st.dispatches,
        "warm_transfers": st.warm_transfers,
        "fleet_evals_saved": st.fleet_evals_saved,
        "isolated_evaluations": int(isolated_evals),
        "evals_saved_vs_isolated":
            int(isolated_evals - summary["plugin"]["evaluations"]),
        "recovery_ratio": None,
        "final_tunables": [t.as_dict() for t in fleet.current],
    }


_KINDS = {"session": _run_session_scenario,
          "fleet": _run_fleet_scenario,
          "crash": _run_crash_restore_scenario,
          "serving": _run_serving_scenario}

# the manifest's kinds the port does not run yet, and the ROADMAP item each
# waits for
UNPORTED_KINDS = {
    "elastic": "ROADMAP A7 (distribution: a device mesh and "
               "elastic_restore)",
    "elastic_session": "ROADMAP A7 (distribution: a device mesh and "
                       "elastic_restore)",
}


def _check_ported(name: str, spec: dict) -> None:
    kind = spec.get("kind", "session")
    if kind in UNPORTED_KINDS:
        raise NotImplementedError(
            f"scenario {name!r} is of kind {kind!r}, which the port does not "
            f"run yet: {UNPORTED_KINDS[kind]}")


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


def _eval_gates(name: str, spec: dict, metrics: dict, *,
                seed: int, impl: str, device) -> dict:
    gates = {}

    def gate(key, ok, value, want):
        gates[key] = {"pass": bool(ok), "value": value, "want": want}

    g = spec.get("gates", {})
    if "min_recovery_ratio" in g:
        want = float(g["min_recovery_ratio"])
        ratio = metrics.get("recovery_ratio")
        gate("min_recovery_ratio",
             ratio is not None and ratio >= want and metrics["recovered"],
             ratio, want)
    if g.get("require_events"):
        have = set(metrics.get("events", {}))
        want = list(g["require_events"])
        gate("require_events", set(want) <= have, sorted(have), want)
    if "min_retunes" in g:
        gate("min_retunes", metrics.get("retunes", 0) >= g["min_retunes"],
             metrics.get("retunes", 0), g["min_retunes"])
    if "min_searches" in g:
        gate("min_searches", metrics.get("searches", 0) >= g["min_searches"],
             metrics.get("searches", 0), g["min_searches"])
    if "min_known_workloads" in g:
        gate("min_known_workloads",
             metrics.get("known_workloads", 0) >= g["min_known_workloads"],
             metrics.get("known_workloads", 0), g["min_known_workloads"])
    if g.get("winner_matches_clean"):
        clean_spec = {k: v for k, v in spec.items()
                      if k not in ("faults", "resilient", "gates")}
        clean = _run_session_scenario(clean_spec, seed=seed, impl=impl,
                                      device=device)
        gate("winner_matches_clean",
             metrics["final_tunables"] == clean["final_tunables"],
             metrics["final_tunables"], clean["final_tunables"])
    if "knob_pinned" in g:
        knob, want = g["knob_pinned"]["knob"], g["knob_pinned"]["value"]
        have = metrics.get("applied_tunables", {}).get(knob)
        gate("knob_pinned", have == want, have, want)
    if g.get("bitwise_decisions"):
        gate("bitwise_decisions", metrics.get("decisions_match"),
             metrics.get("decisions_match"), True)
    if "min_restores" in g:
        gate("min_restores",
             metrics.get("restores", 0) >= g["min_restores"],
             metrics.get("restores", 0), g["min_restores"])
    if "min_checkpoints" in g:
        gate("min_checkpoints",
             metrics.get("checkpoints", 0) >= g["min_checkpoints"],
             metrics.get("checkpoints", 0), g["min_checkpoints"])
    if "min_replans_after_change" in g:
        gate("min_replans_after_change",
             metrics.get("replans_after_change", 0)
             >= g["min_replans_after_change"],
             metrics.get("replans_after_change", 0),
             g["min_replans_after_change"])
    if "max_p99_ratio" in g:
        want = float(g["max_p99_ratio"])
        ratio = metrics.get("p99_ratio")
        gate("max_p99_ratio", ratio is not None and ratio <= want,
             ratio, want)
    if "max_human_calls" in g:
        gate("max_human_calls",
             metrics.get("human_calls", 0) <= g["max_human_calls"],
             metrics.get("human_calls", 0), g["max_human_calls"])
    if "min_warm_started" in g:
        gate("min_warm_started",
             metrics.get("warm_transfers", 0) >= g["min_warm_started"],
             metrics.get("warm_transfers", 0), g["min_warm_started"])
    if "min_fleet_evals_saved" in g:
        gate("min_fleet_evals_saved",
             metrics.get("fleet_evals_saved", 0)
             >= g["min_fleet_evals_saved"],
             metrics.get("fleet_evals_saved", 0),
             g["min_fleet_evals_saved"])
    if "min_evals_saved_vs_isolated" in g:
        gate("min_evals_saved_vs_isolated",
             metrics.get("evals_saved_vs_isolated", 0)
             >= g["min_evals_saved_vs_isolated"],
             metrics.get("evals_saved_vs_isolated", 0),
             g["min_evals_saved_vs_isolated"])
    return gates


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def run_scenario(name: str, spec: dict, *, seed: int = 0,
                 impl: str = "auto", device=None) -> dict:
    """One (scenario, seed, impl) cell -> a schema-versioned artifact dict.
    ``device``: where the session runs (None: CUDA)."""
    dev = resolve_device(device)
    kind = spec.get("kind", "session")
    _check_ported(name, spec)
    runner = _KINDS.get(kind)
    if runner is None:
        raise ValueError(f"unknown scenario kind {kind!r} for {name!r}; "
                         f"choose from {sorted(_KINDS)}")
    t0 = time.perf_counter()
    metrics = runner(spec, seed=seed, impl=impl, device=dev)
    gates = _eval_gates(name, spec, metrics, seed=seed, impl=impl,
                        device=dev)
    return {
        "schema_version": SCHEMA_VERSION,
        "scenario": name,
        "seed": seed,
        "impl": impl,
        "device": str(dev),
        "spec": spec,
        "metrics": metrics,
        "gates": gates,
        "ok": all(v["pass"] for v in gates.values()),
        "seconds": round(time.perf_counter() - t0, 3),
    }


def _default_run_id(manifest: dict) -> str:
    spec_hash = hashlib.sha1(
        json.dumps(manifest, sort_keys=True).encode()).hexdigest()[:8]
    return time.strftime("%Y%m%d-%H%M%S") + "-" + spec_hash


def run_manifest(manifest=None, *, out_dir="results",
                 run_id: Optional[str] = None, only=None, smoke: bool = False,
                 seeds=None, impls=None, verbose: bool = False,
                 device=None) -> dict:
    """Sweep the manifest; write per-run artifacts + summary index under
    ``<out_dir>/<RUN_ID>/`` and return the summary dict.

    ``smoke`` restricts to the manifest's declared smoke subset (the CI
    shape); ``only`` filters scenario names; ``seeds``/``impls`` override
    the manifest-level sweeps; ``device`` is where every session runs
    (None: CUDA).  A selected scenario of an unported kind raises before
    any scenario runs.
    """
    man = manifest if isinstance(manifest, dict) else load_manifest(manifest)
    names = list(man["scenarios"])
    if smoke:
        sm = man.get("smoke", {})
        names = [n for n in sm.get("scenarios", names) if n in names]
        seeds = seeds if seeds is not None else sm.get("seeds")
    if only:
        keep = set(only)
        names = [n for n in names if n in keep]
    seeds = list(seeds if seeds is not None else man.get("seeds", [0]))
    impls = list(impls if impls is not None else man.get("impls", ["auto"]))
    for name in names:
        _check_ported(name, man["scenarios"][name])
    dev = resolve_device(device)

    run_id = run_id or _default_run_id(man)
    run_dir = Path(out_dir) / run_id
    run_dir.mkdir(parents=True, exist_ok=True)

    runs = []
    for name in names:
        spec = man["scenarios"][name]
        for seed in seeds:
            for impl in spec.get("impls", impls):
                art = run_scenario(name, spec, seed=seed, impl=impl,
                                   device=dev)
                art["run_id"] = run_id
                fname = f"{name}--seed{seed}--{impl}.json"
                (run_dir / fname).write_text(json.dumps(art, indent=2))
                if verbose:
                    print(f"  {name:24s} seed={seed} impl={impl:6s} "
                          f"{'ok' if art['ok'] else 'FAIL'} "
                          f"({art['seconds']:.1f}s)")
                runs.append({
                    "scenario": name, "seed": seed, "impl": impl,
                    "artifact": fname, "ok": art["ok"],
                    "gates": {k: v["pass"] for k, v in art["gates"].items()},
                    "recovery_ratio": art["metrics"].get("recovery_ratio"),
                })
    summary = {
        "schema_version": SCHEMA_VERSION,
        "run_id": run_id,
        "scenarios": names,
        "seeds": seeds,
        "impls": impls,
        "device": str(dev),
        "smoke": bool(smoke),
        "runs": runs,
        "all_ok": all(r["ok"] for r in runs),
    }
    (run_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    (Path(out_dir) / "LATEST").write_text(run_id + "\n")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--manifest", default=None,
                    help="manifest path (default: bundled manifest.json)")
    ap.add_argument("--out", default="results", help="artifact root")
    ap.add_argument("--run-id", default=None)
    ap.add_argument("--only", action="append", default=None,
                    help="restrict to this scenario (repeatable)")
    ap.add_argument("--seed", "--seeds", action="extend", nargs="+",
                    type=int, default=None, dest="seeds",
                    help="override manifest seeds (repeatable)")
    ap.add_argument("--impl", action="append", default=None, dest="impls",
                    help="override manifest impls (repeatable)")
    ap.add_argument("--smoke", action="store_true",
                    help="manifest's smoke subset (the CI shape)")
    ap.add_argument("--device", default=None,
                    help="where the sessions run (default: cuda)")
    args = ap.parse_args(argv)
    summary = run_manifest(args.manifest, out_dir=args.out,
                           run_id=args.run_id, only=args.only,
                           smoke=args.smoke, seeds=args.seeds,
                           impls=args.impls, verbose=True,
                           device=args.device)
    print(f"run {summary['run_id']}: {len(summary['runs'])} runs, "
          f"all_ok={summary['all_ok']}")
    return 0 if summary["all_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
