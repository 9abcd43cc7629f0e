import os
import sys
from pathlib import Path

# never inherit the dry-run's 512-device flag; tests see 1 CPU device
os.environ.pop("XLA_FLAGS", None)

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import pytest  # noqa: E402

from repro.configs.base import ShapeSpec, reduced  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402


def tiny(arch: str, **kw):
    """Extra-small family-faithful config for fast unit tests."""
    cfg = reduced(get_config(arch))
    small = dict(n_layers=2, d_model=64, n_heads=2,
                 n_kv_heads=1 if cfg.n_kv_heads == 1 else 2,
                 d_ff=128, vocab=256, head_dim=32)
    if cfg.hybrid_period:
        small["hybrid_period"] = 2
        small["n_layers"] = 5            # 2 groups + 1 remainder layer
    if cfg.enc_layers:
        small["enc_layers"] = 2
    if cfg.num_patches:
        small["num_patches"] = 8
    small.update(kw)
    return cfg.replace(**small)


@pytest.fixture
def rng_key():
    import jax
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is not "
        "available (the PyTorch port's kernel tests)")
