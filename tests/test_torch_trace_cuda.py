"""The span recorder's clock against torch.profiler's device clock on the
card: kernels launched inside a span lie inside the span's interval
mapped onto the trace's clock (``trace.trace_us``, by the span's own
``time.time_ns()`` anchor), within ``TOL_US``; and the latency from the
host's call of an operation to its start on an idle card, beside which
``kbench/spans.py`` takes each decode step's own (its opening to its
first operation) when it puts decode idle down to host spans.  Each test
prints its numbers (run with ``-s``).  Marked
``cuda``: skips where there is no GPU.  Imports no JAX:

    python -m pytest -q -s -m cuda tests/test_torch_trace_cuda.py
"""
import json
import statistics
import time

import pytest
import torch

from repro_torch.runtime import trace as T

pytestmark = pytest.mark.cuda

TOL_US = 50.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    return torch.device("cuda")


def _device_profile(fn):
    """Run ``fn()`` in the active step of a device-only profiler, as the
    benchmark's traced calls run, after 64 spin kernels (the profiler
    there has lost a trace's first device records); returns (fn's
    result, the device events from ``fn`` on as (name, start us, end
    us), the profiler's host launch events' starts in us)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        prof.step()
        for _ in range(64):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        time.sleep(0.01)
        start = time.time_ns() / 1e3
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    dev, launches = [], []
    for e in prof.profiler.kineto_results.events():
        b = e.start_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), b, b + e.duration_ns() / 1e3))
        elif "LaunchKernel" in e.name():
            launches.append(b)
    return (out, sorted((ev for ev in dev if ev[1] >= start),
                        key=lambda ev: ev[1]),
            sorted(b for b in launches if b >= start))


def _quartiles(v):
    q = statistics.quantiles(v, n=4)
    return {"min": min(v), "q1": q[0], "median": q[1], "q3": q[2],
            "max": max(v), "n": len(v)}


def test_kernels_lie_inside_their_span(cuda_device):
    x = torch.randn(2048, 2048, device=cuda_device)
    T.reset()

    def probes():
        out = []
        for i in range(40):
            time.sleep(0.001)
            with T.span("probe", i=i) as sp:
                sp.anchor()
                h = time.perf_counter()
                y = x @ x
                y.add_(1.0)
                y @ y
                torch.cuda.synchronize()
            out.append((sp, h))
        return out
    got, ops, launches = _device_profile(probes)
    assert len(ops) >= 3 * len(got)
    outside, leads, tails, early = 0.0, [], [], []
    for sp, h in got:
        lo, hi = T.trace_us(sp.start, sp), T.trace_us(sp.end, sp)
        mine = [(b, e) for _, b, e in ops
                if lo - TOL_US <= b and e <= hi + TOL_US]
        assert len(mine) >= 3, (sp, lo, hi)
        outside = max(outside, lo - mine[0][0], mine[-1][1] - hi)
        leads.append(mine[0][0] - lo)
        tails.append(hi - max(e for _, e in mine))
        # the profiler's own host stamp of the first launch after ``h``
        mapped = T.trace_us(h, sp)
        first = next((b for b in launches if b >= mapped - TOL_US), None)
        if first is not None:
            early.append(first - mapped)
    # every device operation of the window lies in some probe's span
    spans_us = [(T.trace_us(sp.start, sp), T.trace_us(sp.end, sp))
                for sp, _ in got]
    lost = [ev for ev in ops if not any(lo - TOL_US <= ev[1]
                                        and ev[2] <= hi + TOL_US
                                        for lo, hi in spans_us)]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "tolerance_us": TOL_US, "ops": len(ops), "ops_outside": len(lost),
        "worst_outside_us": outside,
        "first_op_after_span_start_us": _quartiles(leads),
        "span_end_after_last_op_us": _quartiles(tails),
        "profiler_launch_after_host_stamp_us": (_quartiles(early)
                                                if len(early) > 1 else None)}))
    assert not lost and outside <= TOL_US
    assert min(leads) > -TOL_US and min(tails) > -TOL_US


def test_launch_latency(cuda_device):
    """Host call of a small operation to its start on an idle card, under
    the device-only profiler."""
    x = torch.zeros(256, device=cuda_device)
    stamps = []

    def issue():
        with T.span("latency") as sp:
            sp.anchor()
            for _ in range(200):
                torch.cuda.synchronize()
                time.sleep(0.0002)
                stamps.append(time.perf_counter())
                x.add_(1.0)
            torch.cuda.synchronize()
        return sp
    sp, ops, launches = _device_profile(issue)
    adds = [b for n, b, _ in ops if "elementwise" in n]
    k = min(len(adds), len(stamps), len(launches))
    assert k >= 150
    host = [T.trace_us(h, sp) for h in stamps[-k:]]
    lat = [b - h for b, h in zip(adds[-k:], host)]
    q = _quartiles(lat)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "launch_latency_us": q,
        # the two legs: the profiler's host stamp of the launch after the
        # mapped Python stamp, and the device start after that launch
        "profiler_launch_after_host_stamp_us": _quartiles(
            [b - h for b, h in zip(launches[-k:], host)]),
        "device_start_after_profiler_launch_us": _quartiles(
            [b - a for a, b in zip(launches[-k:], adds[-k:])])}))
    assert 0.0 < q["median"] < 200.0
