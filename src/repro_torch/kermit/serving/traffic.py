"""Trace-driven traffic generation for the autonomic serving loop.

Port of ``repro/kermit/serving/traffic.py`` (numpy; copied): the same
seed renders a bit-identical schedule in both packages.

A ``TrafficGenerator`` renders a seeded, fully deterministic request
schedule: windows of requests, each request carrying an arrival offset, a
tenant, a prompt length and a decode length.  The executor replays the
schedule against the real ``ServeEngine`` — traffic supplies *what arrives
when*, measurement supplies *how long it takes*.

Arrival offsets are expressed in abstract *service units* (multiples of one
request's service time at the default configuration); the executor
calibrates the unit against the actual machine once, so "dense" traffic
saturates and "sparse" traffic idles on any hardware speed — the queueing
regime is part of the trace, not an accident of the host.

Phase mixes reuse the Knowledge phase's Dirichlet machinery (the k-way
hybrid synthesis, ``core/simulator.generate_hybrid``): ``TrafficGenerator.
kway`` draws per-window tenant weights from the same Dirichlet(2, ..., 2)
prior, so multi-tenant traffic drifts the way the synthesized hybrid
workloads do.

Built-in shapes:

  diurnal   alternating sparse interactive / dense bulk phases (day/night)
  bursty    a steady phase where a fraction of requests arrive in bursts
  kway      k tenant profiles, per-window Dirichlet-weighted mixing
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

# tenant name -> request profile.  Prompt lengths come from a small bucket
# set so the compiled-shape zoo stays bounded on CPU CI.
TENANT_PROFILES = {
    "chat":   {"prompt_len": 16, "gen_min": 4,  "gen_max": 8},
    "agent":  {"prompt_len": 32, "gen_min": 6,  "gen_max": 10},
    "bulk":   {"prompt_len": 48, "gen_min": 12, "gen_max": 16},
}

_TENANTS = tuple(TENANT_PROFILES)

# compressed-gap share for burst arrivals; the complementary stretch keeps
# the phase's mean gap (and hence its offered load) unchanged
_BURST_COMPRESS = 0.05


@dataclass(frozen=True)
class TrafficPhase:
    """One stationary traffic regime.

    ``gap`` is the mean inter-arrival gap in service units: ``gap >> 1`` is
    sparse interactive traffic (batches wait to fill), ``gap << 1`` is
    saturating bulk traffic (requests queue).  ``mix`` weights tenants from
    ``TENANT_PROFILES``; None draws per-window Dirichlet(2,...) weights over
    ``tenants`` instead (the k-way hybrid convention).
    """
    name: str
    n_windows: int
    gap: float = 1.0
    burstiness: float = 0.0                       # fraction of burst arrivals
    tenants: Tuple[str, ...] = ("chat",)
    mix: Optional[Tuple[float, ...]] = None       # None = Dirichlet per window

    def __post_init__(self):
        unknown = [t for t in self.tenants if t not in TENANT_PROFILES]
        if unknown:
            raise ValueError(f"unknown tenant(s) {unknown}; "
                             f"choose from {sorted(TENANT_PROFILES)}")
        if self.mix is not None and len(self.mix) != len(self.tenants):
            raise ValueError("mix length must match tenants")


@dataclass
class RequestWindow:
    """``window_size`` consecutive requests — one observation window."""
    index: int                     # global window index
    phase: str
    phase_index: int               # index into the generator's phase list
    arrivals: np.ndarray           # (W,) offsets from window start, svc units
    tenant: np.ndarray             # (W,) indices into TENANT_PROFILES order
    prompt_len: np.ndarray         # (W,)
    gen: np.ndarray                # (W,)
    gap: float = 0.0               # the phase's mean gap (telemetry signal)

    def __len__(self) -> int:
        return len(self.arrivals)


class TrafficGenerator:
    """Seeded request-schedule renderer: same seed, bit-identical trace."""

    def __init__(self, phases: Sequence[TrafficPhase], *,
                 window_size: int = 8, seed: int = 0):
        if not phases:
            raise ValueError("TrafficGenerator needs at least one phase")
        self.phases = list(phases)
        self.window_size = int(window_size)
        self.seed = int(seed)

    # -- canned shapes -------------------------------------------------------

    @classmethod
    def diurnal(cls, *, window_size: int = 8, seed: int = 0,
                night_windows: int = 16, day_windows: int = 16,
                cycles: int = 1, night_gap: float = 4.0,
                day_gap: float = 0.25) -> "TrafficGenerator":
        """Sparse interactive nights alternating with dense bulk days."""
        phases = []
        for _ in range(cycles):
            phases.append(TrafficPhase("night", night_windows, gap=night_gap,
                                       tenants=("chat",)))
            phases.append(TrafficPhase("day", day_windows, gap=day_gap,
                                       tenants=("bulk",)))
        return cls(phases, window_size=window_size, seed=seed)

    @classmethod
    def bursty(cls, *, window_size: int = 8, seed: int = 0,
               n_windows: int = 24, gap: float = 1.0,
               burstiness: float = 0.5,
               tenants: Tuple[str, ...] = ("chat", "agent")
               ) -> "TrafficGenerator":
        """One stationary phase with a burst-arrival fraction."""
        phase = TrafficPhase("bursty", n_windows, gap=gap,
                             burstiness=burstiness, tenants=tenants,
                             mix=tuple(1.0 / len(tenants)
                                       for _ in tenants))
        return cls([phase], window_size=window_size, seed=seed)

    @classmethod
    def kway(cls, tenants: Sequence[str] = _TENANTS, *,
             window_size: int = 8, seed: int = 0, n_windows: int = 24,
             gap: float = 1.0) -> "TrafficGenerator":
        """k-way multi-tenant mixing: per-window Dirichlet(2,...) weights
        over the tenant set — the k-way hybrid-synthesis prior as traffic."""
        phase = TrafficPhase("kway", n_windows, gap=gap,
                             tenants=tuple(tenants), mix=None)
        return cls([phase], window_size=window_size, seed=seed)

    # -- schedule rendering --------------------------------------------------

    def phase_boundaries(self) -> list:
        """Global window indices at which a new phase begins (excluding 0)."""
        bounds, acc = [], 0
        for p in self.phases[:-1]:
            acc += p.n_windows
            bounds.append(acc)
        return bounds

    @property
    def n_windows(self) -> int:
        return sum(p.n_windows for p in self.phases)

    def schedule(self) -> list:
        """Materialize the full trace: one ``RequestWindow`` per window."""
        rng = np.random.default_rng(self.seed)
        W = self.window_size
        windows: list = []
        index = 0
        for pi, phase in enumerate(self.phases):
            t_idx = np.array([_TENANTS.index(t) for t in phase.tenants])
            for _ in range(phase.n_windows):
                if phase.mix is not None:
                    weights = np.asarray(phase.mix, np.float64)
                    weights = weights / weights.sum()
                else:
                    weights = rng.dirichlet(np.full(len(t_idx), 2.0))
                tenant = t_idx[rng.choice(len(t_idx), size=W, p=weights)]
                prompt = np.array([TENANT_PROFILES[_TENANTS[t]]["prompt_len"]
                                   for t in tenant], np.int64)
                gen = np.array([rng.integers(
                    TENANT_PROFILES[_TENANTS[t]]["gen_min"],
                    TENANT_PROFILES[_TENANTS[t]]["gen_max"] + 1)
                    for t in tenant], np.int64)
                gaps = rng.exponential(phase.gap, size=W)
                if phase.burstiness > 0.0:
                    b = float(phase.burstiness)
                    burst = rng.random(W) < b
                    stretch = (1.0 - _BURST_COMPRESS * b) / max(1.0 - b, 1e-9)
                    gaps = np.where(burst, gaps * _BURST_COMPRESS,
                                    gaps * stretch)
                windows.append(RequestWindow(
                    index=index, phase=phase.name, phase_index=pi,
                    arrivals=np.cumsum(gaps), tenant=tenant,
                    prompt_len=prompt, gen=gen, gap=float(phase.gap)))
                index += 1
        return windows
