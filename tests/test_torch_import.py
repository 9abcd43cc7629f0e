"""The port stands alone: every module of ``repro_torch`` imports and runs
with ``jax`` and the JAX package (``repro``) made unimportable."""
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"

_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)

import numpy as np
from repro_torch.core.dbscan import dbscan
x = np.concatenate([np.zeros((20, 16)), np.ones((20, 16)) * 5]).astype("f4")
labels = dbscan(x, eps=0.5, min_pts=3, device="cpu")
assert sorted(set(labels.tolist())) == [0, 1], labels
legacy = dbscan(x, eps=0.5, min_pts=3, impl="legacy", device="cpu")
assert (legacy == labels).all(), legacy

import warnings
from repro_torch.core import AutonomicManager
from repro_torch.kermit import (AnalysisConfig, KermitConfig, KermitSession,
                                MonitorConfig, SimulatorExecutor)
ex = SimulatorExecutor([("dense_train", 4), ("decode_serve", 4)],
                       window_size=8, device="cpu")
cfg = KermitConfig(monitor=MonitorConfig(window_size=8),
                   analysis=AnalysisConfig(interval=5), impl="legacy")
with KermitSession(cfg, executor=ex, device="cpu") as s:
    s.run()
    assert s.summary()["windows"] == len(ex.samples) // 8
    assert any(e.kind == "analysis" for e in s.events)
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    AutonomicManager(fast_analysis=False, device="cpu").close()

from repro_torch.configs.base import Tunables
from repro_torch.kermit import ServeEngine
from repro_torch.kermit.serving import tiny_config
eng = ServeEngine(tiny_config("qwen2-1.5b"), device="cpu")
rep = eng.serve(batch=2, prompt_len=16, gen=3,
                tunables=Tunables(attn_impl="pallas"))
assert rep.generated.shape == (2, 4), rep.generated.shape
eng = ServeEngine(tiny_config("mamba2-1.3b"), device="cpu")
rep = eng.serve(batch=2, prompt_len=16, gen=3,
                tunables=Tunables(attn_impl="pallas", ssm_chunk=8))
assert rep.generated.shape == (2, 4), rep.generated.shape
from repro_torch.configs.base import ShapeSpec, reduced
from repro_torch.configs.registry import get_config
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.fault import FailureInjector
from repro_torch.runtime.loop import Trainer
import tempfile
with tempfile.TemporaryDirectory() as d:
    tr = Trainer(reduced(get_config("mamba2-1.3b")).replace(n_layers=2),
                 ShapeSpec("t", 32, 2, "train"),
                 OptConfig(moments_dtype="int8"),
                 Tunables(attn_impl="pallas", ssm_chunk=16), ckpt_dir=d,
                 ckpt_every=2, injector=FailureInjector(fail_steps=(3,)),
                 device="cpu")
    rep = tr.run(4)
assert rep.steps_done == 4 and rep.failures_recovered == 1, rep
from repro_torch.scenarios import load_manifest, run_scenario
art = run_scenario("crash_restore",
                   load_manifest()["scenarios"]["crash_restore"],
                   device="cpu")
assert art["ok"] and art["metrics"]["restores"] == 1, art["gates"]
print(" ".join(names))
print(len(names))
"""

# modules of the serving slice, each of which must be among those walked
SERVING_SLICE = [
    "repro_torch.configs.registry", "repro_torch.configs.qwen2_1_5b",
    "repro_torch.runtime.telemetry", "repro_torch.models.layers",
    "repro_torch.kernels.flash_attention", "repro_torch.models.transformer",
    "repro_torch.models.model", "repro_torch.train.step",
    "repro_torch.kermit.serving", "repro_torch.kermit.serving.traffic",
    "repro_torch.kermit.serving.engine", "repro_torch.kermit.serving.executor",
    "repro_torch.launch.serve",
]
# modules of the SSM slice
SSM_SLICE = [
    "repro_torch.configs.mamba2_1_3b", "repro_torch.configs.zamba2_7b",
    "repro_torch.kernels.ssd_scan", "repro_torch.models.mamba2",
    "repro_torch.models.ssm_lm",
]
# modules of the seed-path slice (the dense kernel lives in
# kernels.pairdist, the seed paths in the existing core modules)
SEED_SLICE = [
    "repro_torch.core.autonomic", "repro_torch.kernels.pairdist",
    "repro_torch.kernels.dispatch", "repro_torch.core.dbscan",
    "repro_torch.core.knowledge", "repro_torch.core.forest",
    "repro_torch.core.lstm", "repro_torch.core.monitor",
    "repro_torch.core.analyser", "repro_torch.kermit.session",
]


# modules of the training slice
TRAIN_SLICE = [
    "repro_torch.optim.adamw", "repro_torch.optim.compression",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.models.registry", "repro_torch.data.pipeline",
    "repro_torch.runtime.checkpoint", "repro_torch.runtime.fault",
    "repro_torch.runtime.loop", "repro_torch.launch.train",
    "repro_torch.convert",
]

# modules of the self-healing slice: durable sessions, chaos, the
# supervisor, the cost model and the scenario runner
DURABLE_SLICE = [
    "repro_torch.kermit.chaos", "repro_torch.kermit.supervisor",
    "repro_torch.core.costmodel", "repro_torch.scenarios",
    "repro_torch.scenarios.runner", "repro_torch.scenarios.__main__",
]


def test_every_module_imports_without_jax_or_reference():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN],
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    *walked, count = proc.stdout.split()
    assert int(count) == len(walked) >= 40          # every module was walked
    assert set(SERVING_SLICE) <= set(walked)
    assert set(SSM_SLICE) <= set(walked)
    assert set(SEED_SLICE) <= set(walked)
    assert set(TRAIN_SLICE) <= set(walked)
    assert set(DURABLE_SLICE) <= set(walked)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)\b(?!_))",
    re.MULTILINE)


def test_no_source_file_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_kermit_api_is_reference_minus_fleet():
    """``repro_torch.kermit.__all__`` is the reference's facade without the
    fleet's three names, which wait for their slice."""
    import repro.kermit as J
    import repro_torch.kermit as K
    fleet = {"FleetConfig", "FleetStats", "KermitFleet"}
    assert fleet <= set(J.__all__)
    assert K.__all__ == [n for n in J.__all__ if n not in fleet]
    for name in K.__all__:              # restore compares class names
        ref = getattr(J, name)
        if isinstance(ref, type):
            assert getattr(K, name).__name__ == ref.__name__, name
