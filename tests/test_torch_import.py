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
print(len(names))
"""


def test_every_module_imports_without_jax_or_reference():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN],
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20      # every module was walked


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)\b(?!_))",
    re.MULTILINE)


def test_no_source_file_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
