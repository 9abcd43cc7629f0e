"""Request latencies from the benchmark's own spans, by a frozen copy of
``ServeExecutor._replay``'s arithmetic
(``repro_torch/kermit/serving/executor.py``).

A committed window's requests are chunked FIFO into batches of the
applied ``serve_batch``; a chunk's prompt is its longest and a short
chunk is padded to the batch with replicas of its shortest output.  A
chunk starts once its last request has arrived (fill wait) and the
engine is free (queue), with each window's queue starting empty; it runs
for its measured service time.  Request i of a chunk completes after the
prefill plus ``gen_i`` of the call's decode steps, the decode wall split
evenly over its steps.  Arrivals are the trace's offsets times one
service unit in seconds, fixed in the cell (``kbench/cells/<cell>.json``:
the median over many runs of the program's calibrated unit, one
request's service time at the initial configuration), so that the load
offered is the same in every run.  The program calibrates its own unit
from one call, for its own decisions; ``unit_from_spans`` reads that
call's span, for the log.
"""
from __future__ import annotations

import math

import numpy as np


def chunks(win, batch: int) -> list:
    """(request indices, prompt, gen vector) of each chunk of ``win``."""
    out, W = [], len(win)
    for lo in range(0, W, batch):
        idx = np.arange(lo, min(lo + batch, W))
        gen = win.gen[idx]
        if batch - len(idx):
            gen = np.concatenate([gen, np.full(batch - len(idx), gen.min())])
        out.append((idx, int(win.prompt_len[idx].max()),
                    np.asarray(gen, np.int64)))
    return out


def _same(c: dict, batch: int, prompt: int, gen) -> bool:
    return (c["batch"] == batch and c["prompt"] == prompt
            and np.array_equal(c["gen"], gen))


def mark_window(calls: list, w: dict) -> None:
    """Mark the engine call that served each chunk of committed window
    ``w`` (``measured``, with ``real_rows`` and the chunk's request
    indices): scanning back from the window's last call, the latest call
    of each chunk's shape, chunk by chunk from the last.  A call of the
    same shape before it was an untimed warm-up or the calibration."""
    batch = max(int(w["tun"].serve_batch), 1)
    limit = w["last"]
    w["chunks"] = []
    for idx, prompt, gen in reversed(chunks(w["win"], batch)):
        j = next((j for j in range(limit - 1, w["first"] - 1, -1)
                  if _same(calls[j], batch, prompt, gen)), None)
        if j is None:
            raise RuntimeError(f"no engine call served a chunk of window "
                               f"{w['win'].index} (batch {batch}, prompt "
                               f"{prompt}, gen {gen.tolist()})")
        calls[j].update(measured=True, real_rows=len(idx), requests=idx)
        w["chunks"].insert(0, j)
        limit = j


def unit_from_spans(rec, initial) -> tuple:
    """The service unit from the span of the calibration: in the first
    committed window, the last call before its first chunk's that has the
    calibration's shape (the initial batch, the window's longest prompt,
    its longest output for every row)."""
    if not rec.windows:
        return None, None
    w = rec.windows[0]
    win, batch = w["win"], max(int(initial.serve_batch), 1)
    gen = np.full(batch, int(win.gen.max()), np.int64)
    prompt = int(win.prompt_len.max())
    for j in range(w["chunks"][0] - 1, w["first"] - 1, -1):
        c = rec.calls[j]
        if _same(c, batch, prompt, gen):
            return (c["t1"] - c["t0"]) / batch, "spans"
    return None, None


def latencies(rec, unit: float) -> np.ndarray:
    """Every committed request's latency, in window order."""
    out = []
    for w in rec.windows:
        win = w["win"]
        arrivals = win.arrivals * unit
        lat = np.zeros(len(win), np.float64)
        t_free = 0.0
        for j in w["chunks"]:
            c = rec.calls[j]
            idx, n = c["requests"], c["real_rows"]
            prefill = c["tp"] - c["t0"]
            step = (c["t1"] - c["tp"]) / max(c["steps"], 1)
            completion = prefill + step * c["gen"][:n].astype(np.float64)
            start = max(float(arrivals[idx[-1]]), t_free)
            t_free = start + (c["t1"] - c["t0"])
            lat[idx] = start + completion - arrivals[idx]
        out.append(lat)
    return np.concatenate(out) if out else np.zeros(0)


def served_tokens(calls: list) -> int:
    """Output tokens of the committed requests that ``calls`` served, as
    ``ServeReport.tokens`` counts them: ``gen + 1`` a request, a chunk's
    pad rows left out."""
    return int(sum(int(c["gen"][:c["real_rows"]].sum()) + c["real_rows"]
                   for c in calls))


def p95_nearest_rank(x) -> float:
    """The 95th percentile, nearest rank: the ⌈0.95·n⌉-th smallest."""
    x = np.sort(np.asarray(x, np.float64))
    return float(x[max(math.ceil(0.95 * len(x)), 1) - 1])
