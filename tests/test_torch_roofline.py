"""The port's roofline terms against the JAX package's.

Mirrors ``tests/test_roofline_parse.py``: the HLO parser's bytes by kind
and ``roofline_terms`` at the TPU v5e constants equal the reference's on
the same inputs; the terms at the H100 SXM's constants (the port's
default); ``count_params`` and ``model_flops`` equal the reference's for
every arch at full width and every shape it supports, the reference on
``jax.eval_shape`` trees, the port on fake-tensor trees (nothing
allocated).  ``repro.analysis.roofline`` sets no environment variable, so
both run in this process.
"""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import roofline as JR
from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.models import model as JM
from repro_torch.analysis import roofline as R
from repro_torch.configs.base import SHAPES, supports
from repro_torch.configs.registry import get_config
from repro_torch.models import model as M

HLO = """
ENTRY main {
  %p = bf16[128,1024]{1,0} parameter(0)
  %ag = bf16[2048,1024]{1,0} all-gather(bf16[128,1024]{1,0} %p), replica_groups=[16,16]<=[256]T(1,0), dimensions={0}
  %ar = f32[512,512]{1,0} all-reduce(f32[512,512]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%sum
  %rs = f32[64,256]{1,0} reduce-scatter(f32[1024,256]{1,0} %y), replica_groups=[1,16]<=[16], dimensions={0}
  %cp = bf16[32,32]{1,0} collective-permute(bf16[32,32]{1,0} %z), source_target_pairs={{0,1}}
  %a2a = (f32[8,8]{1,0}, f32[8,8]{1,0}) all-to-all(f32[8,8]{1,0} %u, f32[8,8]{1,0} %v), replica_groups={{0,1}}
  %ars = f32[16]{0} all-reduce-start(f32[16]{0} %w), replica_groups={{0,1,2,3,4,5,6,7}}
}
"""


def test_collective_bytes_equal_reference():
    port, ref = R.collective_bytes(HLO), JR.collective_bytes(HLO)
    assert port == ref
    assert abs(port["all-gather"] - 2048 * 1024 * 2 * 15 / 16) < 1
    assert abs(port["reduce-scatter"] - 64 * 256 * 4 * 15) < 1
    assert port["total"] == sum(v for k, v in port.items() if k != "total")


@pytest.mark.parametrize("kind,g,want", [
    ("all-reduce", 4, 1.5), ("reduce-scatter", 16, 15.0),
    ("all-gather", 16, 15 / 16), ("all-to-all", 2, 0.5),
    ("collective-permute", 8, 1.0)])
def test_ring_factors(kind, g, want):
    assert R.ring_factor(kind, g) == want


@pytest.mark.parametrize("coll", [5.0e8, 5.0e9, 0.0])
def test_roofline_terms_equal_reference_at_v5e(coll):
    cost = {"flops": 1.97e12, "bytes accessed": 8.19e9}
    kw = dict(chips=256, model_flops=1.97e12 * 256 * 0.5)
    port = R.roofline_terms(cost, {"total": coll}, chip=R.V5E, **kw)
    ref = JR.roofline_terms(cost, {"total": coll}, **kw)
    assert port.as_dict() == ref.as_dict()
    assert (R.V5E.peak_flops, R.V5E.hbm_bw, R.V5E.link_bw) == \
        (JR.PEAK_FLOPS, JR.HBM_BW, JR.LINK_BW)


def test_roofline_terms_at_h100():
    cost = {"flops": 9.89e12, "bytes accessed": 3.35e10}
    r = R.roofline_terms(cost, {"total": 5.0e8}, chips=8,
                         model_flops=9.89e12 * 8 * 0.25)
    assert R.roofline_terms(cost, {"total": 5.0e8}, chips=8,
                            model_flops=1.0, chip=R.H100).compute_s == \
        r.compute_s
    np.testing.assert_allclose(r.compute_s, 0.01)
    np.testing.assert_allclose(r.memory_s, 0.01)
    np.testing.assert_allclose(r.collective_s, 0.01)
    assert r.useful_ratio == 0.25
    assert R.roofline_terms(cost, {"total": 5.0e9}, chips=8,
                            model_flops=1.0).bottleneck == "collective"
    assert R.roofline_terms({"flops": 1e14}, {}, chips=1,
                            model_flops=1.0).bottleneck == "compute"


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_equal_reference(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jtree = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg))
    with FakeTensorMode():
        tree = M.init(torch.Generator(), cfg)
    port, ref = R.count_params(tree, cfg), JR.count_params(jtree, jcfg)
    print(f"{arch}: N_total {port[0]:.6g}, N_active {port[1]:.6g}")
    assert port == ref
    for name, shape in SHAPES.items():
        if supports(cfg, shape):
            assert R.model_flops(cfg, shape, port[1]) == \
                JR.model_flops(jcfg, shape, ref[1]), name
