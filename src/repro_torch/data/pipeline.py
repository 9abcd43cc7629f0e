"""Synthetic-token data pipeline: deterministic, resumable, prefetching.

Port of ``repro/data/pipeline.py``.  Batches come from a counter-keyed
numpy generator (seed, step) making the reference's draws, so the two
packages see bit-identical batches and the pipeline state is ONE integer:
checkpointing it makes the data exactly resumable after a restart.  A
background thread keeps ``prefetch`` batches ready (the host side of the
input pipeline; ``host_wait_s`` is the consumer's wait for the last one).
``next()`` returns tensors on the pipeline's device (None: CUDA).
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import input_specs


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, *, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2, device=None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.step = start_step
        self.prefetch = max(prefetch, 1)
        self.device = resolve_device(device)
        self._specs = input_specs(cfg, shape)
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._wait_s = 0.0
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- deterministic batch synthesis ---------------------------------------

    def _make(self, step: int) -> dict:
        """The reference's numpy arrays for ``step``, draw for draw."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        out = {}
        for k, (shp, dtype) in self._specs.items():
            if dtype == torch.int32:
                if k == "pos":
                    out[k] = np.asarray(self.shape.seq_len - 1, np.int32)
                else:
                    out[k] = rng.integers(0, self.cfg.vocab,
                                          shp).astype(np.int32)
            elif k == "mask":
                out[k] = np.ones(shp, np.float32)
            else:
                out[k] = rng.standard_normal(shp).astype(np.float32)
        return out

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    # -- consumer API ---------------------------------------------------------

    def next(self) -> dict:
        t0 = time.perf_counter()
        step, batch = self._q.get()
        self._wait_s = time.perf_counter() - t0
        self.step = step + 1
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    @property
    def host_wait_s(self) -> float:
        return self._wait_s

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)

    @classmethod
    def restore(cls, cfg, shape, state: dict, prefetch: int = 2,
                device=None):
        return cls(cfg, shape, seed=state["seed"], start_step=state["step"],
                   prefetch=prefetch, device=device)
