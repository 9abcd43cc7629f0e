"""repro_torch.kermit — the public facade of the port.

The ported subset of ``repro.kermit.__all__``: the config tree, the
session, the executors, the event vocabulary and autonomic serving.
Chaos, fleet and the supervisor arrive with later slices (ROADMAP).

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
from repro_torch.kermit.serving import (SERVE_SPACE, ServeConfig, ServeEngine,
                                        ServeExecutor, TrafficGenerator,
                                        TrafficPhase, run_serving_session)

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
    "SERVE_SPACE",
    "ServeConfig",
    "ServeEngine",
    "ServeExecutor",
    "SimulatorExecutor",
    "TrafficGenerator",
    "TrafficPhase",
    "resolve_impl",
    "run_serving_session",
]
