"""repro_torch.kermit.serving — KERMIT managing the real inference stack.

Port of ``repro/kermit/serving``.  The MAPE-K loop tunes a workload it
did not simulate: a ``ServeEngine`` (params + cached prefill/decode over
the ``launch/serve.py`` stack), a seeded trace-driven ``TrafficGenerator``
(diurnal / bursty / k-way multi-tenant mixes), and a ``ServeExecutor``
closing the Execute boundary with tail-latency-aware measurement.

    engine = ServeEngine(tiny_config("qwen2-1.5b"))     # on CUDA
    traffic = TrafficGenerator.diurnal(window_size=8, seed=0)
    ex = ServeExecutor(engine, traffic)
    with KermitSession(cfg, executor=ex) as session:
        run_serving_session(session, ex)   # re-plans ride traffic phases
"""
from repro_torch.kermit.serving.engine import (ServeEngine, ServeReport,
                                               get_engine, tiny_config)
from repro_torch.kermit.serving.executor import (SERVE_SPACE, ServeConfig,
                                                 ServeExecutor,
                                                 run_serving_session)
from repro_torch.kermit.serving.traffic import (TENANT_PROFILES,
                                                RequestWindow,
                                                TrafficGenerator,
                                                TrafficPhase)

__all__ = [
    "RequestWindow",
    "SERVE_SPACE",
    "ServeConfig",
    "ServeEngine",
    "ServeExecutor",
    "ServeReport",
    "TENANT_PROFILES",
    "TrafficGenerator",
    "TrafficPhase",
    "get_engine",
    "run_serving_session",
    "tiny_config",
]
