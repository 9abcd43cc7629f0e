"""Durable sessions on the card: a supervised run killed by a
``CrashFault`` and restored from its latest snapshot decides bit for bit
as the run that never died — the analyses replayed after the restore
re-fit the forest and the LSTM on the card and must land on the same
models.  Marked ``cuda``: skips where there is no GPU.  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_durability_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kermit import (AnalysisConfig, ChaosExecutor, CrashFault,
                                EventKind, ExecConfig, KermitConfig,
                                KermitSupervisor, KnowledgeConfig,
                                MonitorConfig, PlanConfig, ResilientExecutor,
                                SimulatorExecutor, StragglerFault)
from repro_torch.kernels import pairdist as P
from repro_torch.scenarios import load_manifest, run_scenario

pytestmark = pytest.mark.cuda

SPACE = {"microbatches": [1, 2, 4], "remat": ["dots", "none"],
         "grad_compression": [False, True]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decisions(session):
    evs = [e for e in session.events
           if e.kind not in (EventKind.RESTORE.value,
                             EventKind.CHECKPOINT.value)]
    return ([(e.window_id, str(e.kind), e.label, e.tunables) for e in evs],
            np.asarray(session.monitor.label_log).tolist(),
            vars(session.plugin.stats).copy(), session.current.as_dict())


@pytest.mark.parametrize("crash_at", [17, 33])
def test_kill_and_restore_bit_identical_on_card(cuda_device, tmp_path,
                                                crash_at):
    cfg = KermitConfig(monitor=MonitorConfig(window_size=8),
                       analysis=AnalysisConfig(interval=8, min_windows=6),
                       plan=PlanConfig(space=SPACE),
                       knowledge=KnowledgeConfig(drift_eps=0.45),
                       execute=ExecConfig(checkpoint_every=4))

    def factory(crash):
        def build():
            sim = SimulatorExecutor([("dense_train", 24),
                                     ("moe_train", 16)], window_size=8,
                                    seed=0, device=cuda_device)
            faults = [StragglerFault(at_window=14, factor=3.0)]
            if crash:
                faults.append(CrashFault(at_window=crash_at))
            return ResilientExecutor(ChaosExecutor(sim, faults, seed=0,
                                                   window_size=8),
                                     max_retries=2)
        return build

    P.LAUNCHES = 0
    clean = KermitSupervisor(cfg, factory(False),
                             checkpoint_path=tmp_path / "clean.npz",
                             device=cuda_device)
    clean.run()
    clean_launches = P.LAUNCHES
    crashed = KermitSupervisor(cfg, factory(True),
                               checkpoint_path=tmp_path / "crash.npz",
                               device=cuda_device)
    report = crashed.run()
    assert report["crashes"] == report["restores"] == 1
    assert _decisions(crashed.session) == _decisions(clean.session)
    analyses = sum(e.kind == EventKind.ANALYSIS.value
                   for e in clean.session.events)
    assert clean_launches == analyses > 0        # every analysis on the card
    assert P.LAUNCHES >= 2 * clean_launches       # and the crashed run too


def test_crash_restore_scenario_gates_on_card(cuda_device):
    spec = load_manifest()["scenarios"]["crash_restore"]
    art = run_scenario("crash_restore", spec, seed=0, device=cuda_device)
    assert art["device"].startswith("cuda")
    assert art["ok"], art["gates"]
