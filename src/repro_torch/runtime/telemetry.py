"""Telemetry: per-step measurements -> KERMIT feature vectors (the KAgnt/KPlg
stream, DESIGN.md §2 mapping table).

Port of ``repro/runtime/telemetry.py`` (numpy; copied).

Measured live on any backend: step wall-time, tokens/s, host-input wait,
loss/grad stats. Derived: MFU and HBM proxies from the configured model flops
and a peak constant (real peaks on TPU; a calibrated CPU constant here so the
*relative* signal — what KERMIT actually consumes — is meaningful).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.core.windows import FEATURES, NUM_FEATURES

_IDX = {f: i for i, f in enumerate(FEATURES)}


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (no interpolation): the smallest sample x
    such that at least ``q`` percent of the samples are <= x.

    Deterministic and exact — the returned value is always one of the
    samples, so serving p99 gates compare actual measured latencies rather
    than interpolated artifacts.  ``q`` is in [0, 100]; q=0 returns the
    minimum, q=100 the maximum.
    """
    a = np.sort(np.asarray(values, np.float64).reshape(-1))
    if a.size == 0:
        raise ValueError("percentile() of empty sample set")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    rank = int(np.ceil(q / 100.0 * a.size))
    return float(a[max(rank, 1) - 1])


@dataclass
class StepStats:
    step_time: float
    tokens: int
    loss: float = 0.0
    grad_norm: float = 0.0
    host_wait: float = 0.0
    expert_imbalance: float = 0.0
    cache_occ: float = 0.0
    decode: bool = False
    recompute_frac: float = 0.0


class TelemetryEmitter:
    def __init__(self, *, seq_len: int, global_batch: int,
                 model_flops_per_step: float = 0.0,
                 peak_flops: float = 2e11,      # calibrated CPU-core peak
                 root: str | Path | None = None, agent: str = "agent0"):
        self.seq_len = seq_len
        self.batch = global_batch
        self.mf = model_flops_per_step
        self.peak = peak_flops
        self._prev_loss = None
        self._file = None
        if root is not None:
            lz = Path(root) / "lz"
            lz.mkdir(parents=True, exist_ok=True)
            self._file = (lz / f"{agent}.jsonl").open("a")
        self.samples: list[np.ndarray] = []

    def emit(self, s: StepStats) -> np.ndarray:
        f = np.zeros(NUM_FEATURES, np.float32)
        f[_IDX["step_time"]] = min(s.step_time, 10.0) / 10.0
        f[_IDX["tokens_per_s"]] = min(s.tokens / max(s.step_time, 1e-6) / 1e6,
                                      1.0)
        f[_IDX["mfu"]] = min(self.mf / max(s.step_time, 1e-6) / self.peak, 1.0)
        f[_IDX["hbm_util"]] = min(0.5 * f[_IDX["tokens_per_s"]] +
                                  0.5 * f[_IDX["mfu"]], 1.0)
        f[_IDX["coll_frac"]] = 0.0
        f[_IDX["host_wait"]] = min(s.host_wait / max(s.step_time, 1e-6), 1.0)
        f[_IDX["peak_mem_frac"]] = 0.0
        f[_IDX["grad_norm"]] = min(s.grad_norm / 10.0, 1.0)
        if self._prev_loss is not None:
            f[_IDX["loss_delta"]] = np.clip(self._prev_loss - s.loss, -1, 1)
        self._prev_loss = s.loss
        f[_IDX["expert_imbalance"]] = s.expert_imbalance
        f[_IDX["cache_occ"]] = s.cache_occ
        f[_IDX["seq_len_log"]] = np.log2(max(self.seq_len, 2)) / 20.0
        f[_IDX["batch_log"]] = np.log2(max(self.batch, 2)) / 10.0
        f[_IDX["decode_frac"]] = 1.0 if s.decode else 0.0
        f[_IDX["recompute_frac"]] = s.recompute_frac
        f[_IDX["io_rate"]] = f[_IDX["tokens_per_s"]]
        self.samples.append(f)
        if self._file is not None:
            self._file.write(json.dumps(
                {"t": time.time(), "f": f.tolist()}) + "\n")
            self._file.flush()
        return f
