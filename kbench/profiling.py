"""Device traces of single serve calls, framed by spin kernels.

Copied from ``chip_smoke.py`` (``classify_spins``, the spin lengths and
the framing of ``_profile_once``): on the H100 machine torch.profiler
has lost a trace's first device records, so the recorded step puts spin
kernels of distinct lengths around the call (a hold, 64 leads, a marker,
and a closing one after it), and a trace counts as complete only when
the spins show that any loss was a prefix ended before the marker and
every launch of the repo's kernels that their wrappers counted is in it.

Here the call is traced where it happens, inside the measured window,
and the trace is read only after the window has closed (``read``), so
reading it costs the window nothing.  Only device activity is recorded.
"""
from __future__ import annotations

import time

import torch

# a wrapper's launch counter -> a substring of its kernel's name
TRACE_NAMES = {"flash_attention/bfloat16": "flash_fwd_wgmma",
               "flash_attention/float32": "flash_fwd_kernel",
               "ssd_scan/bfloat16": "ssd_fwd_mma",
               "ssd_scan/float32": "ssd_fwd_kernel",
               "nbr_adjacency": "nbr_adjacency_kernel"}
PROFILER_PAD_S = 0.05
# the idle before the call, one per attempt: after an incomplete trace the
# next traced call gets the next, longer lead
PROFILE_LEADS_S = (0.05, 0.5, 2.0)
SPIN_HOLD, SPIN_LEAD, SPIN_MARK, SPIN_CLOSE = 10_000_000, 20_000, 200_000, \
    1_000_000
LEAD_SENTINELS = 64


def wrapper_launches() -> dict:
    """The program's launch counters, keyed as ``TRACE_NAMES``."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import pairdist as PD
    from repro_torch.kernels import ssd_scan as SSD
    out = {"nbr_adjacency": PD.LAUNCHES}
    for name, mod in (("flash_attention", FA), ("ssd_scan", SSD)):
        out.update({f"{name}/{dt}": n
                    for dt, n in mod.LAUNCHES_BY_DTYPE.items()})
    return out


def classify_spins(spans: list) -> dict:
    """The spin kernels of one trace, ``spans`` as (start, end) in us.
    The shortest seen is a short opening one (at least two must be seen);
    the others are classified by their length over it.  The trace's losses
    are shown to be a prefix of the window, ended before the call, when
    the spins seen read, in order of start, [hold], lead x k (k >= 2),
    marker, closing, and no lead between the first seen and the marker is
    missing: each starts within half a lead's length of the end of the one
    before."""
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
    marker_end = next((e for (b, e), k in zip(spans, kinds)
                       if k == "marker"), None)
    return {"loss_is_a_prefix": bool(prefix), "marker_end_us": marker_end}


def traced(fn, lead: float):
    """Run ``fn()`` inside the recorded step of a device-only profiler,
    framed by spins; returns (fn's result, the unread trace)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
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
        out = fn()
        torch.cuda.synchronize()
        after = wrapper_launches()
        torch.cuda._sleep(SPIN_CLOSE)
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
        prof.step()
    expected = {k: after[k] - before[k] for k in TRACE_NAMES}
    return out, {"prof": prof, "expected": expected, "lead_s": lead}


def _device_events(prof) -> list:
    """(name, start us, end us) of every device event of the recorded
    step, from the profiler's raw results (building its event tree is
    slow: ~0.45 ms an event on the card's host)."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            b = e.start_ns() / 1e3
            out.append((e.name(), b, b + e.duration_ns() / 1e3))
    except AttributeError:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out.append((e.name, e.time_range.start, e.time_range.end))
    return [ev for ev in out if not ev[0].startswith("ProfilerStep")]


def read(trace: dict) -> dict:
    """The device side of one traced call: its kernels after the marker
    (spins left out) as (name, start us, end us), busy seconds, whether
    the trace is complete, and the launches seen against those counted."""
    events = _device_events(trace.pop("prof"))
    spins = [(b, e) for n, b, e in events if "spin_kernel" in n]
    frame = classify_spins(spins)
    start = frame["marker_end_us"] or float("-inf")
    ops = sorted((ev for ev in events if "spin_kernel" not in ev[0]
                  and ev[1] >= start), key=lambda ev: ev[1])
    seen = {k: sum(sub in n for n, _, _ in ops)
            for k, sub in TRACE_NAMES.items()}
    complete = (frame["loss_is_a_prefix"]
                and all(seen[k] == trace["expected"][k] for k in TRACE_NAMES))
    busy, end = 0.0, float("-inf")
    for _, b, e in ops:                       # union of the intervals
        b = max(b, end)
        if e > b:
            busy += e - b
            end = e
    return {"ops": ops, "busy_s": busy / 1e6, "complete": complete,
            "seen": seen, "expected": trace["expected"],
            "lead_s": trace["lead_s"]}
