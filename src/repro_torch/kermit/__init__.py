"""repro_torch.kermit — the public facade of the port.

The ported subset of ``repro.kermit.__all__``: the config tree, the
session (with durable checkpoints), the executors and their chaos and
resilience layers, the supervisor, the event vocabulary and autonomic
serving.  The fleet (``FleetConfig``, ``FleetStats``, ``KermitFleet``)
arrives with a later slice (ROADMAP queue A).

    from repro_torch.kermit import KermitConfig, KermitSession, SimulatorExecutor
    with KermitSession(cfg, executor=SimulatorExecutor(schedule)) as s:
        s.run()
"""
from repro_torch.kermit.chaos import (ChaosExecutor, CrashFault, NoiseFault,
                                      ResilientExecutor, SessionCrash,
                                      StragglerFault, StuckKnobFault,
                                      TransientFaults, fault_from_dict)
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
from repro_torch.kermit.supervisor import KermitSupervisor

__all__ = [
    "AnalysisConfig",
    "AutonomicEvent",
    "BatchExecutor",
    "CallableExecutor",
    "ChaosExecutor",
    "CrashFault",
    "EVENT_KINDS",
    "EventKind",
    "ExecConfig",
    "Executor",
    "ExecutorObjective",
    "IMPL_CHOICES",
    "KermitConfig",
    "KermitSession",
    "KermitSupervisor",
    "KnowledgeConfig",
    "MonitorConfig",
    "NoiseFault",
    "PlanConfig",
    "ResilientExecutor",
    "SERVE_SPACE",
    "ServeConfig",
    "ServeEngine",
    "ServeExecutor",
    "SessionCrash",
    "SimulatorExecutor",
    "StragglerFault",
    "StuckKnobFault",
    "TrafficGenerator",
    "TrafficPhase",
    "TransientFaults",
    "fault_from_dict",
    "resolve_impl",
    "run_serving_session",
]
