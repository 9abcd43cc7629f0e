"""The fleet on the card: ``KermitFleet`` decides as isolated
``KermitSession``s do, with every phase on the GPU — the vmapped monitor
step over stacked cohort parameters, the shared knowledge base, each
tenant's analyses with the ε-neighbour kernel.  Marked ``cuda``: skips
where there is no GPU.  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_fleet_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.monitor import FASTPATH_STATS
from repro_torch.kermit import (AnalysisConfig, FleetConfig, KermitConfig,
                                KermitFleet, KermitSession, KnowledgeConfig,
                                MonitorConfig, PlanConfig, SimulatorExecutor)
from repro_torch.kernels import pairdist as P

pytestmark = pytest.mark.cuda

W = 16
SPACE = {"microbatches": [1, 2, 4], "remat": ["dots", "none"],
         "grad_compression": [False, True]}
SCHED = [("dense_train", 20), ("moe_train", 20), ("dense_train", 12)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _config():
    return KermitConfig(monitor=MonitorConfig(window_size=W),
                        analysis=AnalysisConfig(interval=12),
                        plan=PlanConfig(space=SPACE),
                        knowledge=KnowledgeConfig(drift_eps=0.45))


def _decisions(events):
    return [(e.window_id, str(e.kind), e.label, e.tunables,
             {k: v for k, v in e.detail.items() if k != "seconds"})
            for e in events]


@pytest.mark.parametrize("S", [3, 4])
def test_fleet_equals_isolated_sessions_on_card(cuda_device, S):
    def executor(t):
        return SimulatorExecutor(SCHED, window_size=W, seed=t,
                                 device=cuda_device)
    P.LAUNCHES = 0
    fleet = KermitFleet(FleetConfig(tenants=S, base=_config()),
                        executors=executor, device=cuda_device)
    fleet.run()
    assert P.LAUNCHES == fleet.stats.analyses > 0
    assert fleet.stats.ticks == fleet.ring.total
    assert fleet.stats.warm_transfers >= 1
    for co in fleet._cohorts:
        assert co.clf_stack["thr"].device.type == "cuda"
        assert co.stage_f.is_pinned()
    for t in range(S):
        with KermitSession(_config(), executor=executor(t),
                           device=cuda_device) as sess:
            sess.run()
            np.testing.assert_array_equal(sess.monitor.label_log,
                                          fleet.ring.ordered(t)[2])
            assert _decisions(sess.events) == _decisions(
                [e for e in fleet.events if e.tenant == t])
            assert sess.current == fleet.current[t]
            view = fleet.tenant_db(t)
            assert {k: r.config for k, r in sess.db.records.items()} == \
                {k: r.config for k, r in view.records.items()}


def test_one_step_per_cohort_and_tick(cuda_device):
    fleet = KermitFleet(FleetConfig(tenants=5, base=_config()),
                        device=cuda_device)
    before = FASTPATH_STATS["dispatches"]
    x = np.random.default_rng(0).normal(size=(5, 7 * W, 16))
    fleet.ingest(x.astype(np.float32))
    assert fleet.stats.ticks == fleet.stats.dispatches == 7
    assert FASTPATH_STATS["dispatches"] - before == 7


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_cpu_strategies_refused_on_card(cuda_device, impl):
    with pytest.raises(ValueError, match="CPU kernel strategy"):
        KermitFleet(FleetConfig(base=KermitConfig(impl=impl)),
                    device=cuda_device)
