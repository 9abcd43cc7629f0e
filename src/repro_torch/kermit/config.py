"""KermitConfig — the declarative configuration tree for the MAPE-K loop.

Port of ``repro/kermit/config.py`` (copied; ``impl`` keeps its
value set so reference JSON specs round-trip — see
``repro_torch/kernels/dispatch.py`` for what each value means on a
device).

One frozen dataclass per phase of the loop (paper Fig. 3):

  MonitorConfig    KWmon windowing + on-line ChangeDetector thresholds
  AnalysisConfig   KWanl cadence + DBSCAN discovery + training-pipeline knobs
  PlanConfig       KPlg search space / staleness policy / default Tunables
  KnowledgeConfig  WorkloadDB persistence root + drift threshold
  ExecConfig       Execute-phase policy (how selected Tunables are applied)

plus two tree-level fields:

  impl   the unified implementation policy, replacing the scattered
         ``fast_analysis`` / ``fast_monitor`` / ``dbscan_impl`` /
         ``fast=False`` flags (see ``resolve_impl``)
  clock  optional injectable *window-count* clock (callable -> int) used by
         the Plan phase's staleness guard; None means "the monitor's own
         emitted-window counter".  Deliberately excluded from serialization.

The tree round-trips through plain JSON dicts (``to_dict``/``from_dict``)
so experiment specs can live in version-controlled files; ``from_dict``
rejects unknown keys, catching spec typos before a run starts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# ---------------------------------------------------------------------------
# Unified implementation policy
# ---------------------------------------------------------------------------

# accepted ``KermitConfig.impl`` values -> (fast_monitor, fast_analysis,
# kernel dispatch impl).  "auto"/"fast" pick the compiled fast paths with
# backend auto-dispatch; "legacy"/"seed" freeze the original seed
# implementation end to end (benchmark baseline / parity oracle); the
# remaining values force a specific kernel backend while keeping the fast
# monitor/analysis paths (see kernels/dispatch.py and ROADMAP dispatch rules).
_IMPL_TABLE = {
    "auto": (True, True, "auto"),
    "fast": (True, True, "auto"),
    "legacy": (False, False, "legacy"),
    "seed": (False, False, "legacy"),
    "pallas": (True, True, "pallas"),
    "pallas_interpret": (True, True, "pallas_interpret"),
    "xla": (True, True, "xla"),
}

IMPL_CHOICES = tuple(_IMPL_TABLE)


def resolve_impl(impl: str) -> tuple[bool, bool, str]:
    """``impl`` policy -> (fast_monitor, fast_analysis, dbscan_impl)."""
    try:
        return _IMPL_TABLE[impl]
    except KeyError:
        raise ValueError(
            f"unknown impl policy {impl!r}; choose from {IMPL_CHOICES}"
        ) from None


# ---------------------------------------------------------------------------
# Per-phase sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MonitorConfig:
    """KWmon: windowing, bounded streaming state, on-line detector."""
    window_size: int = 32
    retention: int = 4096            # WindowRing capacity (windows)
    ctx_retention: Optional[int] = None   # context deque bound; None -> retention
    ctx_flush_every: int = 64        # buffered JSONL flush interval (windows)
    detector_alpha: float = 0.01     # Welch per-feature significance
    detector_quorum: float = 0.25    # changed-feature fraction for transition


@dataclass(frozen=True)
class AnalysisConfig:
    """KWanl: off-line cadence, discovery, and training-pipeline knobs."""
    interval: int = 24               # windows between analysis runs
    min_windows: int = 8             # skip analysis below this history length
    dbscan_eps: float = 0.35
    dbscan_min_pts: int = 4
    max_classes: int = 64
    synthesize_hybrids: bool = True  # ZSL hybrid synthesis (paper §7 step 7)
    zsl_k: int = 3                   # max mixture order: anticipate up to
    #                                  zsl_k concurrent archetypes per window


@dataclass(frozen=True)
class PlanConfig:
    """KPlg: Explorer search space and the Algorithm-1 policy knobs."""
    space: Optional[dict] = None     # knob -> candidates; None -> DEFAULT_SPACE
    max_passes: int = 3              # hill-climb sweeps per global search
    max_memo: int = 4096             # Explorer evaluation-cache bound
    max_trace: int = 4096            # SearchResult.trace bound (evict oldest)
    batch_eval: bool = True          # use Executor.measure_batch when offered
    chunk: int = 512                 # batched exhaustive streaming chunk size
    warm_start: bool = True          # seed searches from nearest stored config
    max_staleness_windows: int = 256  # pull-path staleness guard (windows)
    default_tunables: Optional[dict] = None  # J^D override; None -> defaults
    # model-based Plan (core/costmodel.py — ROADMAP item 4).  All defaults
    # keep the learned path OFF: model_guided=False reproduces the PR 4
    # batched searches bit-identically (winner, cost, evaluation count).
    model_guided: bool = False       # rank the grid with a learned cost model
    significance: float = 0.0        # prune knobs w/ main effect < frac of max
    #                                  (0 = no pruning; Tuneful-style)
    regret_bound: float = 0.25       # model-mistrust bound: committed-winner
    #                                  relative misprediction above this falls
    #                                  back to the PR 4 paths (also the
    #                                  oracle-differential harness's asserted
    #                                  regret bound)
    min_trace: int = 32              # stored trace rows before the model is
    #                                  trusted (cold model -> PR 4 fallback)
    eval_budget: float = 0.10        # measured evals <= budget * grid size
    #                                  on the model-guided path


@dataclass(frozen=True)
class KnowledgeConfig:
    """WorkloadDB: persistence root (lz/tz/az zones), drift thresholds and
    the bounded-store policy (see docs/api.md "Knowledge")."""
    root: Optional[str] = None
    drift_eps: float = 1.0
    drift_alpha: float = 0.0         # EMA floor on fresh-batch blend weight
    #                                  (0 = seed count-weighted merge)
    merge_eps: float = 0.0           # class-convergence merge distance
    #                                  (0 = merging disabled)
    max_records: int = 1024          # bounded store: LRU/priority eviction


@dataclass(frozen=True)
class ExecConfig:
    """Execute phase: how the session commits selected Tunables."""
    apply_on_retune: bool = True     # executor.apply() on every retune commit
    measure_repeats: int = 1         # trial-step repeats for measured objectives
    recovery_threshold: float = 0.9  # pre/post-fault throughput ratio above
    #                                  which a RECOVERY event counts as
    #                                  recovered (chaos harness gate)
    # durability defaults (KermitSupervisor reads these when its own
    # arguments are omitted — see kermit/supervisor.py):
    checkpoint_every: int = 8        # windows between supervisor checkpoints
    max_restores: int = 3            # supervised deaths tolerated per run


_SUBTREES = {
    "monitor": MonitorConfig,
    "analysis": AnalysisConfig,
    "plan": PlanConfig,
    "knowledge": KnowledgeConfig,
    "execute": ExecConfig,
}


@dataclass(frozen=True)
class KermitConfig:
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    analysis: AnalysisConfig = field(default_factory=AnalysisConfig)
    plan: PlanConfig = field(default_factory=PlanConfig)
    knowledge: KnowledgeConfig = field(default_factory=KnowledgeConfig)
    execute: ExecConfig = field(default_factory=ExecConfig)
    impl: str = "auto"
    max_events: int = 4096
    clock: Optional[Callable[[], int]] = None   # window-count clock (see module doc)

    def __post_init__(self):
        resolve_impl(self.impl)      # fail fast on unknown policies

    def replace(self, **kw) -> "KermitConfig":
        return dataclasses.replace(self, **kw)

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> dict:
        """Plain-JSON spec of the tree.  ``clock`` is a runtime injection
        point, not configuration data, and is never serialized."""
        out: dict[str, Any] = {name: dataclasses.asdict(getattr(self, name))
                               for name in _SUBTREES}
        out["impl"] = self.impl
        out["max_events"] = self.max_events
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "KermitConfig":
        kw: dict[str, Any] = {}
        unknown = []
        for key, value in d.items():
            sub = _SUBTREES.get(key)
            if sub is not None:
                sub_fields = {f.name for f in dataclasses.fields(sub)}
                bad = sorted(set(value) - sub_fields)
                if bad:
                    unknown.extend(f"{key}.{b}" for b in bad)
                    continue
                kw[key] = sub(**value)
            elif key in ("impl", "max_events"):
                kw[key] = value
            else:
                unknown.append(key)
        if unknown:
            raise ValueError(f"unknown KermitConfig keys: {unknown}")
        return cls(**kw)
