"""The seeded request renderer every traffic mix goes through.

Copied from ``repro_torch/kermit/serving/traffic.py`` (the windows, the
phases, arrivals in service units) and extended with length
distributions, so that the program's own traffic module can change
without moving the yardstick.  A mix is a data file,
``kbench/traffic/<name>.json``:

    {"window_size": 8,
     "phases": [{"name": "sparse", "gap": 4.0, "windows": 4}, ...],
     "prompt": {"buckets": [512, 1024], "weights": [0.5, 0.5]},
     "output": {"dist": "lognormal", "median": 13, "sigma": 1.0,
                "min": 1, "max": 64},
     "deal_seed": 12345}

``output.dist`` is ``lognormal`` (median, sigma) or ``uniform``
(min..max, whole numbers).  ``gap`` is a phase's mean inter-arrival gap
in service units (the executor calibrates one unit as one request's
service time at the initial configuration), so the offered load is
relative to the machine by construction.

Each window's lengths are a draw from the mix's distributions.  The
phases repeat in order, each for its ``windows`` windows.  A phase's
block of windows holds, between them, one multiset of
``window_size * windows`` prompt buckets (counts by largest remainder of
the weights) and output lengths (the distribution's quantiles at
(k + 0.5) / n), which a seeded stream deals out in an order of its own;
so which lengths share a window, and what its batches pad to, is drawn
as from the distributions, while the block's total is fixed.  Each
window's ``window_size - 1`` gaps between arrivals are the exponential's
quantiles, permuted by the same stream (the first request arrives at the
window's start), so every window of a phase spans the same time.

The stream is seeded by the mix's ``deal_seed`` where the file names
one: then every run seed is handed the same windows, and the run's seed
draws only the data (weights and prompt tokens), so that KERMIT meets
the same work on every seed.  Without it the run's seed deals.  An output length counts the decode steps after the
prefill's token, as the program's ``gen`` does: a request is served
``gen + 1`` tokens.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

import numpy as np


@dataclass
class RequestWindow:
    """One observation window: the fields ``ServeExecutor`` reads."""
    index: int
    phase: str
    phase_index: int
    arrivals: np.ndarray       # (W,) offsets from the window's start, units
    tenant: np.ndarray         # (W,) zeros: one tenant
    prompt_len: np.ndarray     # (W,) prompt buckets
    gen: np.ndarray            # (W,) decode steps after the first token
    gap: float = 0.0

    def __len__(self) -> int:
        return len(self.arrivals)


def load_mix(root: Path, name: str) -> dict:
    return json.loads((Path(root) / "kbench" / "traffic" /
                       f"{name}.json").read_text())


def bucket_counts(weights, n: int) -> list:
    """``n`` split by ``weights`` into whole counts, largest remainder."""
    w = np.asarray(weights, np.float64)
    share = w / w.sum() * n
    counts = np.floor(share).astype(int)
    order = np.argsort(-(share - counts), kind="stable")
    for i in order[:n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def output_quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` output lengths: the distribution's quantiles at
    (k + 0.5) / n, rounded and clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    p = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(q)) for q in p])
        vals = np.exp(math.log(float(spec["median"])) + float(spec["sigma"])
                      * z)
    elif spec["dist"] == "uniform":
        vals = lo + p * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown output distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def gap_quantiles(gap: float, n: int) -> np.ndarray:
    """``n`` exponential inter-arrival gaps of mean ``gap``, its
    quantiles at (k + 0.5) / n."""
    p = (np.arange(n) + 0.5) / n
    return -float(gap) * np.log1p(-p)


class Traffic:
    """The schedule of one mix and seed, with the interface
    ``ServeExecutor`` takes from a traffic generator: ``schedule()``,
    ``window_size``, ``seed``, ``n_windows``, ``phase_boundaries()``."""

    def __init__(self, mix: dict, seed: int, n_windows: int):
        self.mix = mix
        self.window_size = int(mix["window_size"])
        self.seed = int(seed)
        self.deal_seed = int(mix.get("deal_seed", seed))
        phases = mix["phases"]
        blocks, total = [], 0
        while total < n_windows:
            p = phases[len(blocks) % len(phases)]
            blocks.append(p)
            total += int(p["windows"])
        self.blocks = blocks
        self.n_windows = total

    def phase_boundaries(self) -> list:
        out, acc = [], 0
        for p in self.blocks[:-1]:
            acc += int(p["windows"])
            out.append(acc)
        return out

    def block_pool(self, phase: dict) -> tuple:
        """The unpermuted prompts and outputs of one block of ``phase``,
        and the unpermuted gaps of one of its windows."""
        n = self.window_size * int(phase["windows"])
        pr = self.mix["prompt"]
        prompts = np.repeat(np.asarray(pr["buckets"], np.int64),
                            bucket_counts(pr["weights"], n))
        return (prompts, output_quantiles(self.mix["output"], n),
                gap_quantiles(float(phase["gap"]), self.window_size - 1))

    def schedule(self) -> list:
        rng = np.random.default_rng(self.deal_seed)
        W = self.window_size
        windows, index = [], 0
        for bi, phase in enumerate(self.blocks):
            prompts, outputs, gaps = self.block_pool(phase)
            prompts, outputs = rng.permutation(prompts), \
                rng.permutation(outputs)
            for k in range(int(phase["windows"])):
                own = slice(k * W, (k + 1) * W)
                windows.append(RequestWindow(
                    index=index, phase=str(phase["name"]), phase_index=bi,
                    arrivals=np.concatenate([[0.0],
                                             np.cumsum(rng.permutation(gaps))]),
                    tenant=np.zeros(W, np.int64),
                    prompt_len=prompts[own], gen=outputs[own],
                    gap=float(phase["gap"])))
                index += 1
        return windows
