"""ServeExecutor — the real inference stack behind the Execute boundary.

Port of ``repro/kermit/serving/executor.py`` on the port's
``MeasureCounters``: the replay, the tail-aware cost and the telemetry
rows are the reference's numpy arithmetic, copied, so the same engine
timings give bit-identical latencies, costs, window logs and telemetry.

The serving counterpart to ``SimulatorExecutor``: implements the full
``Executor``/``BatchExecutor`` protocol (with the unified counter surface)
over a live ``ServeEngine`` replaying a ``TrafficGenerator`` trace.

Measurement is tail-latency-aware.  A window's requests are chunked FIFO
into batches of ``serve_batch`` and served for real; per-request latency is
queueing delay (from the trace's calibrated arrival times) + batch-fill
wait + measured service time.  The scalar cost the Plan phase minimizes is

    cost = (1 - tail_weight) * mean(latency) + tail_weight * p99(latency)

so a configuration that helps the mean but wrecks the tail loses the
search.  Every committed window also logs p99 / mean / tokens-per-second to
``window_log`` — the serving gates (re-plan on phase change, p99 must not
regress) read that log, and per-request latencies feed the telemetry stream
the session ingests.

Telemetry rows are dominated by deterministic traffic-shape signals
(arrival pressure, context occupancy, decode fraction) plus seeded noise;
measured wall-times contribute at their honest normalized scale (~1e-4), so
*workload* changes drive discovery while *configuration* changes cannot
masquerade as new workloads — the stability condition for a closed loop
that reconfigures the very system it observes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import DEFAULT_TUNABLES, Tunables
from repro_torch.core.windows import FEATURES, NUM_FEATURES
from repro_torch.kermit.executor import MeasureCounters
from repro_torch.kermit.serving.engine import ServeEngine, tiny_config
from repro_torch.kermit.serving.traffic import RequestWindow, TrafficGenerator
from repro_torch.runtime import trace as T
from repro_torch.runtime.telemetry import percentile

_IDX = {f: i for i, f in enumerate(FEATURES)}

# the serving knob grid (the Tunables fields the Plan phase searches when
# managing the inference stack; training knobs stay at their defaults)
SERVE_SPACE = {
    "serve_batch": [2, 4, 8],
    "cache_len": [32, 64],
    "prefill_chunk": [0, 16],
}


@dataclass(frozen=True)
class ServeConfig:
    """Declarative spec for a managed serving stack (JSON round-trip)."""
    arch: str = "qwen2-1.5b"
    engine_seed: int = 0             # params identity (never the traffic seed)
    window_size: int = 8             # requests per observation window
    max_context: int = 128           # cache-occupancy normalizer (tokens)
    tail_q: float = 99.0             # latency percentile the cost guards
    tail_weight: float = 0.5         # p99 share of the scalar cost
    noise: float = 0.02              # telemetry noise scale (Welch variance)
    probe_repeats: int = 1           # best-of-k probe replays (noise floor)

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown ServeConfig keys: {unknown}")
        return cls(**d)


class ServeExecutor(MeasureCounters):
    """Executor/BatchExecutor over a live ServeEngine + traffic trace.

    ``apply`` stages a configuration on the engine; ``measure`` replays the
    *probe window* (the most recently committed traffic window) under the
    applied configuration and returns the tail-aware latency cost.  Batched
    measurement is a probe: candidates are priced with explicit tunables
    overrides, never moving the applied state.  ``serve_window`` commits a
    window for real — logging latencies and emitting the telemetry rows the
    session ingests — and ``telemetry_stream()`` drives the whole trace
    through the closed loop (``session.run_live(ex.telemetry_stream())``).
    """

    def __init__(self, engine: ServeEngine, traffic: TrafficGenerator, *,
                 config: Optional[ServeConfig] = None,
                 initial: Tunables = DEFAULT_TUNABLES):
        self.engine = engine
        self.traffic = traffic
        self.config = config or ServeConfig(window_size=traffic.window_size)
        self.windows = traffic.schedule()
        self._cursor = 0
        self.windows_served = 0
        self.window_log: list = []        # per committed window: p99/mean/...
        self.request_latencies: list = [] # flat committed latency samples (s)
        self._probe: Optional[RequestWindow] = \
            self.windows[0] if self.windows else None
        self._unit: Optional[float] = None    # calibrated service unit (s)
        self._warm: set = set()               # (tun, batch, prompt, cap) seen
        # no vectorized cost model over the knob encoding — hide the arrays
        # fast path from ExecutorObjective probing (same as SimulatorExecutor
        # with a custom scalar cost)
        self.measure_batch_arrays = None
        self.current = initial
        self.engine.apply(initial)
        self._init_counters()

    @classmethod
    def from_config(cls, config: ServeConfig,
                    traffic: Optional[TrafficGenerator] = None, *,
                    traffic_seed: int = 0,
                    initial: Tunables = DEFAULT_TUNABLES,
                    device=None) -> "ServeExecutor":
        """Build the whole managed stack from a declarative spec, its
        engine on ``device`` (None: CUDA)."""
        engine = ServeEngine(tiny_config(config.arch),
                             seed=config.engine_seed, initial=initial,
                             device=device)
        if traffic is None:
            traffic = TrafficGenerator.diurnal(
                window_size=config.window_size, seed=traffic_seed)
        return cls(engine, traffic, config=config, initial=initial)

    # -- Executor protocol ---------------------------------------------------

    def apply(self, tunables: Tunables) -> None:
        self._count_apply(tunables)
        self.engine.apply(tunables)

    def measure(self) -> float:
        trial = self._trial()
        cost = self._probe_cost(self.current)
        self._count_measure(trial)
        return cost

    def measure_batch(self, candidates: Sequence[Tunables]) -> list:
        return self._measure_batch_impl(candidates, self._probe_cost, None)

    # -- the measured replay -------------------------------------------------

    def _calibrate(self, win: RequestWindow, tun: Tunables) -> float:
        """One service unit = one request's measured service time at the
        executor's initial configuration — fixed after first use so the
        trace's arrival times mean the same thing for every candidate."""
        if self._unit is None:
            batch = max(int(tun.serve_batch), 1)
            prompt = int(win.prompt_len.max())
            gen = np.full(batch, int(win.gen.max()), np.int64)
            self._serve_chunk(tun, batch, prompt, gen, "calibrate")  # warm
            rep = self._serve_chunk(tun, batch, prompt, gen, "calibrate")
            self._unit = rep.total_s / batch
        return self._unit

    def _serve_chunk(self, tun: Tunables, batch: int, prompt: int,
                     gen: np.ndarray, purpose: str = "serve"):
        """One engine call, warmed: the first use of a (config, shape)
        combination runs once untimed (``purpose`` "warm"), so one-off
        costs (the kernels' build, the card's first launches, allocator
        growth) never pollute a latency measurement."""
        cap = self.engine.capacity_for(prompt, int(gen.max()), tun)
        key = (tun, batch, prompt, cap)
        if key not in self._warm:
            self.engine.serve(batch=batch, prompt_len=prompt, gen=gen,
                              tunables=tun, purpose="warm")
            self._warm.add(key)
        return self.engine.serve(batch=batch, prompt_len=prompt, gen=gen,
                                 tunables=tun, purpose=purpose)

    def _replay(self, win: RequestWindow, tun: Tunables) -> dict:
        """Serve one traffic window under ``tun`` for real and reconstruct
        per-request latencies from the trace's arrival times.

        Requests are chunked FIFO into batches of ``tun.serve_batch``; a
        chunk starts once its last member has arrived (batch-fill wait) and
        the engine is free (queueing), then runs for its measured service
        time.  Short chunks are padded to the batch size (shape reuse) with
        replicas that are excluded from the stats."""
        unit = self._calibrate(win, tun)
        W = len(win)
        arrivals = win.arrivals * unit
        batch = max(int(tun.serve_batch), 1)
        latencies = np.zeros(W, np.float64)
        t_free = 0.0
        tokens = 0
        for lo in range(0, W, batch):
            idx = np.arange(lo, min(lo + batch, W))
            n = len(idx)
            pad = batch - n
            prompt = int(win.prompt_len[idx].max())
            gen = win.gen[idx]
            if pad:
                gen = np.concatenate([gen, np.full(pad, gen.min())])
            with T.span("executor.chunk", window=int(win.index),
                        requests=idx.tolist(), real_rows=n):
                rep = self._serve_chunk(tun, batch, prompt, gen)
            start = max(float(arrivals[idx[-1]]), t_free)
            t_free = start + rep.total_s
            latencies[idx] = start + rep.completion_s[:n] - arrivals[idx]
            tokens += int(win.gen[idx].sum()) + n
        makespan = max(t_free, float(arrivals[-1])) or 1e-9
        return {
            "latencies": latencies,
            "mean": float(latencies.mean()),
            "p99": percentile(latencies, self.config.tail_q),
            "tokens": tokens,
            "tokens_per_s": tokens / makespan,
        }

    def _probe_cost(self, tun: Tunables) -> float:
        return self.probe_stats(tun)["cost"]

    def probe_stats(self, tun: Tunables,
                    repeats: Optional[int] = None) -> dict:
        """Replay the probe window under ``tun`` (no state change) and
        return the full stats dict including the scalar cost.  With
        ``repeats`` (default ``config.probe_repeats``) > 1, the replay runs
        k times and per-request latencies take their elementwise best —
        the standard noise floor for short wall-clock measurements, so
        candidate rankings reflect the configuration, not scheduler jitter.
        """
        if self._probe is None:
            raise RuntimeError("ServeExecutor has no traffic to probe")
        k = max(int(repeats if repeats is not None
                    else self.config.probe_repeats), 1)
        stats = self._replay(self._probe, tun)
        for _ in range(k - 1):
            again = self._replay(self._probe, tun)
            stats["latencies"] = np.minimum(stats["latencies"],
                                            again["latencies"])
            stats["tokens_per_s"] = max(stats["tokens_per_s"],
                                        again["tokens_per_s"])
        lat = stats["latencies"]
        stats["mean"] = float(lat.mean())
        stats["p99"] = percentile(lat, self.config.tail_q)
        w = self.config.tail_weight
        stats["cost"] = (1.0 - w) * stats["mean"] + w * stats["p99"]
        return stats

    # -- committed traffic ---------------------------------------------------

    def serve_window(self, win: RequestWindow) -> np.ndarray:
        """Serve one window under the *applied* configuration, log its
        latency profile, and return the (W, F) telemetry rows."""
        self._probe = win
        with T.span("executor.window", window=int(win.index)):
            stats = self._replay(win, self.current)
        self.windows_served += 1
        self.window_log.append({
            "window": int(win.index), "phase": win.phase,
            "phase_index": int(win.phase_index),
            "p99": stats["p99"], "mean": stats["mean"],
            "tokens_per_s": stats["tokens_per_s"],
            "tunables": self.current.as_dict(),
        })
        self.request_latencies.extend(float(x) for x in stats["latencies"])
        return self._telemetry(win, stats)

    def telemetry_stream(self):
        """Generator driving the remaining trace: yields one committed
        window's telemetry at a time, so a session retune between windows
        changes how every later window is served (the closed loop)."""
        while self._cursor < len(self.windows):
            win = self.windows[self._cursor]
            self._cursor += 1
            yield self.serve_window(win)

    def _telemetry(self, win: RequestWindow, stats: dict) -> np.ndarray:
        W = len(win)
        f = np.zeros((W, NUM_FEATURES), np.float32)
        ctx = win.prompt_len + win.gen
        load = 1.0 / (1.0 + win.gap)            # arrival pressure in (0, 1)
        f[:, _IDX["step_time"]] = np.minimum(stats["latencies"], 10.0) / 10.0
        f[:, _IDX["tokens_per_s"]] = min(stats["tokens_per_s"] / 1e6, 1.0)
        f[:, _IDX["host_wait"]] = load
        f[:, _IDX["io_rate"]] = load
        f[:, _IDX["cache_occ"]] = np.minimum(
            ctx / self.config.max_context, 1.0)
        f[:, _IDX["seq_len_log"]] = np.log2(np.maximum(ctx, 2)) / 20.0
        f[:, _IDX["batch_log"]] = np.log2(max(W, 2)) / 10.0
        f[:, _IDX["decode_frac"]] = win.gen / np.maximum(ctx, 1)
        rng = np.random.default_rng((self.traffic.seed, win.index))
        f += rng.normal(0.0, self.config.noise,
                        f.shape).astype(np.float32)
        return np.clip(f, 0.0, 1.0)

    # -- durable-session state (KermitSession.checkpoint / restore) -------

    def export_state(self) -> dict:
        state = MeasureCounters.export_state(self)
        state.update({
            "cursor": self._cursor,
            "windows_served": self.windows_served,
            "unit": self._unit,
            "window_log": [dict(w) for w in self.window_log],
            "request_latencies": list(self.request_latencies),
        })
        return state

    def restore_state(self, state: dict) -> None:
        MeasureCounters.restore_state(self, state)
        self._cursor = int(state["cursor"])
        self.windows_served = int(state["windows_served"])
        self._unit = state["unit"]
        self.window_log = [dict(w) for w in state["window_log"]]
        self.request_latencies = [float(x)
                                 for x in state["request_latencies"]]
        if self._cursor > 0:
            self._probe = self.windows[min(self._cursor,
                                           len(self.windows)) - 1]
        self.engine.apply(self.current)


def run_serving_session(session, executor: ServeExecutor):
    """Close the MAPE-K loop around the live serving stack: drive the
    executor's remaining traffic through the session and return the final
    committed Tunables."""
    return session.run_live(executor.telemetry_stream())
