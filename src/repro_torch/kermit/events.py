"""Typed autonomic events + the subscription surface's vocabulary.

Port of ``repro/kermit/events.py`` (copied).

Every decision the loop makes is recorded as an ``AutonomicEvent`` in a
bounded deque (``KermitSession.events``) and pushed synchronously to any
subscribers registered via ``KermitSession.subscribe``.  ``kind`` values are
the ``EventKind`` enum (a str-enum, so ``event.kind == "retune"`` keeps
working for code that compares against the historical string literals).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class EventKind(str, Enum):
    TRANSITION = "transition"    # monitor flagged a workload transition window
    ANALYSIS = "analysis"        # off-line KWanl run (discovery + retraining)
    RETUNE = "retune"            # plan phase committed a new configuration
    STEADY = "steady"            # reserved: steady-window heartbeat (not emitted)
    # Knowledge-phase adaptation (WorkloadDB journal, drained per analysis):
    DRIFT = "drift"              # class characterization drifted (detail:
    #                              distance/score; rediscovered=True when the
    #                              class diverged past the re-anchor bound)
    MERGE = "merge"              # two classes converged and merged (detail:
    #                              absorbed label, distance)
    EVICT = "evict"              # bounded store evicted a record
    # Chaos / self-healing (chaos-executor journal, drained per context):
    FAULT = "fault"              # injected fault activated (detail: kind,
    #                              window, pre_fault_cost for persistent ones)
    RECOVERY = "recovery"        # first re-plan after a persistent fault
    #                              measured the committed config (detail:
    #                              throughput_ratio, recovered)
    # Durability (session checkpoint/restore + supervisor — see
    # kermit/supervisor.py and docs/architecture.md "Durable MAPE-K"):
    CHECKPOINT = "checkpoint"    # session state snapshotted (detail: path,
    #                              window, version); recorded *before* the
    #                              write so a snapshot contains its own event
    RESTORE = "restore"          # session rebuilt from a snapshot (detail:
    #                              path, window, version)

    def __str__(self) -> str:    # json.dumps/logging friendliness
        return self.value


EVENT_KINDS = tuple(k.value for k in EventKind)


@dataclass
class AutonomicEvent:
    window_id: int
    kind: str                    # an EventKind value
    label: int
    tunables: Optional[dict] = None
    detail: dict = field(default_factory=dict)
    tenant: Optional[int] = None  # fleet tenant index; None = single-session
