"""repro_torch.kermit — the public facade of the port.

The slice-1 subset of ``repro.kermit.__all__``: the config tree, the
session, the executors and the event vocabulary.  Chaos, fleet, serving
and the supervisor arrive with later slices (ROADMAP queue A).

    from repro_torch.kermit import KermitConfig, KermitSession, SimulatorExecutor
    with KermitSession(cfg, executor=SimulatorExecutor(schedule)) as s:
        s.run()
"""
from repro_torch.kermit.config import (AnalysisConfig, ExecConfig,
                                       IMPL_CHOICES, KermitConfig,
                                       KnowledgeConfig, MonitorConfig,
                                       PlanConfig, resolve_impl)
from repro_torch.kermit.events import EVENT_KINDS, AutonomicEvent, EventKind
from repro_torch.kermit.executor import (BatchExecutor, CallableExecutor,
                                         Executor, ExecutorObjective,
                                         SimulatorExecutor)
from repro_torch.kermit.session import KermitSession

__all__ = [
    "AnalysisConfig",
    "AutonomicEvent",
    "BatchExecutor",
    "CallableExecutor",
    "EVENT_KINDS",
    "EventKind",
    "ExecConfig",
    "Executor",
    "ExecutorObjective",
    "IMPL_CHOICES",
    "KermitConfig",
    "KermitSession",
    "KnowledgeConfig",
    "MonitorConfig",
    "PlanConfig",
    "SimulatorExecutor",
    "resolve_impl",
]
