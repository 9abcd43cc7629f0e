"""The port's sharding rules and meshes against the JAX package.

The rules are logic over leaf names and shapes, so both packages run here
in one process: the reference on ``jax.eval_shape`` trees, the port on its
own trees built on the ``meta`` device (full widths, nothing allocated).
Meshes the reference needs at sizes this process has no devices for (a
16-way 'model' axis, a 'pod' axis) are ``jax.sharding.AbstractMesh``es,
which carry names and sizes only, as the rules read them; the port's side
of those is a stand-in with the same two attributes.  The cases of
``tests/test_sharding_and_moe.py:19-82`` are held on the port's trees, and
every tree is compared whole with the reference's.
"""
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs.base import DEFAULT_TUNABLES as J_DEFAULT
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.models import model as JM
from repro.optim.adamw import OptConfig as JOptConfig
from repro.sharding import rules as J
from repro.train.step import init_train_state as j_init_state
from repro_torch.configs.base import DEFAULT_TUNABLES, SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.checkpoint import CheckpointManager, _paths
from repro_torch.runtime.fault import elastic_restore
from repro_torch.sharding import rules as R
from repro_torch.train.step import init_train_state
from conftest import tiny

import torch_parity  # noqa: F401 (one torch thread)


def meta_params(cfg):
    """The port's parameter tree for ``cfg`` on the meta device."""
    gen = types.SimpleNamespace(device=torch.device("meta"))
    with mock.patch.object(L, "_normal", lambda _, shape: torch.empty(
            tuple(shape), device="meta")):
        return M.init(gen, cfg)


def leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def reference_shapes(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), cfg))


def shapes_of(tree):
    return R.tree_map_with_path(lambda _, a: tuple(a.shape), tree)


def j_shapes_of(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def meta_tree(specs):
    """(shape, dtype) pairs (``input_specs``) as meta tensors."""
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in specs.items()}


def fake_mesh(**shape):
    """What the rules read of a mesh: axis names and sizes."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=shape)


@pytest.fixture
def mesh_of():
    """Sets both packages' rules to a mesh of these axis sizes (the
    reference's abstract), and clears them after."""
    def set_both(**shape):
        J.set_mesh(AbstractMesh(tuple(shape.values()), tuple(shape)))
        R.set_mesh(fake_mesh(**shape))
    yield set_both
    J.set_mesh(None)
    R.set_mesh(None)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_tree_equals_reference(arch):
    want_shapes = reference_shapes(arch)
    params = meta_params(get_config(arch))
    assert shapes_of(params) == j_shapes_of(want_shapes)
    for zero3 in (True, False):
        axes = R.param_axes_tree(params, zero3=zero3)
        assert axes == J.param_axes_tree(want_shapes, zero3=zero3)
        ranks_match = R.tree_map_with_path(
            lambda path, a: len(leaf_at(axes, path)) == a.dim(), params)
        assert all(ok for _, ok in _paths(ranks_match))


def test_embed_and_expert_specs():
    axes = R.param_axes_tree(meta_params(get_config("deepseek-moe-16b")))
    assert axes["embed"] == ("model", "data")
    assert axes["layers"]["moe"]["wi"] == (None, "model", "data", None)
    assert axes["layers"]["moe"]["wo"] == (None, "model", None, "data")
    # shared experts are plain mlps: FSDP x TP
    assert axes["layers"]["moe"]["shared"]["wi"] == (None, "data", "model")
    assert axes["layers"]["attn"]["wo"] == (None, "model", "data")
    # zero3 off removes the data axis from params
    axes2 = R.param_axes_tree(
        meta_params(get_config("deepseek-moe-16b")), zero3=False)
    assert axes2["embed"] == ("model", None)


@pytest.mark.parametrize("opt,tun", [
    ({}, {}), ({"moments_dtype": "bfloat16"}, {}),
    ({"moments_dtype": "int8"}, {}), ({}, {"grad_compression": True})],
    ids=["fp32", "bf16", "int8", "ef"])
def test_state_axes_tree_equals_reference(opt, tun):
    cfg = tiny("qwen2-1.5b")
    want = J.state_axes_tree(jax.eval_shape(lambda: j_init_state(
        jax.random.PRNGKey(0), cfg, JOptConfig(**opt),
        J_DEFAULT.replace(**tun))))
    state = init_train_state(torch.Generator().manual_seed(0), tiny_port(),
                             OptConfig(**opt), DEFAULT_TUNABLES.replace(**tun))
    got = R.state_axes_tree(state)
    assert got == want
    if opt.get("moments_dtype") == "int8":
        # moment q mirrors the param; scale drops the last axis
        assert got["opt"]["m"]["embed"][0] == ("model", "data")
        assert got["opt"]["m"]["embed"][1] == ("model", None)
    assert got["opt"]["count"] == ()


def tiny_port():
    """``tests/conftest.py:tiny("qwen2-1.5b")`` in the port's configs."""
    from repro_torch.configs.base import reduced
    return reduced(get_config("qwen2-1.5b")).replace(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256,
        head_dim=32)


@pytest.mark.parametrize("tp", [1, 16])
def test_batch_and_cache_axes_equal_reference(mesh_of, tp):
    if tp > 1:
        mesh_of(data=1, model=tp)
    for arch, shape in (("qwen3-14b", "train_4k"), ("paligemma-3b", "train_4k"),
                        ("qwen3-14b", "decode_32k")):
        got = R.batch_axes_tree(meta_tree(M.input_specs(
            get_config(arch), SHAPES[shape])))
        assert got == J.batch_axes_tree(JM.input_specs(
            j_get_config(arch), J_SHAPES[shape]))
    for arch, shape in (("qwen3-14b", "decode_32k"),
                        ("mamba2-1.3b", "long_500k"),
                        ("zamba2-7b", "decode_32k"),
                        ("deepseek-moe-16b", "decode_32k")):
        cfg, sh = get_config(arch), SHAPES[shape]
        got = R.cache_axes_tree(M.init_cache(cfg, sh.global_batch,
                                             sh.seq_len, device="meta"))
        assert got == J.cache_axes_tree(JM.cache_specs(j_get_config(arch),
                                                       J_SHAPES[shape]))
    caxes = R.cache_axes_tree(M.init_cache(
        get_config("qwen3-14b"), 1, 64, device="meta"))
    k = R.cache_axes_tree(M.init_cache(get_config("qwen3-14b"), 8, 64,
                                       device="meta"))["k"]
    if tp == 1:     # kv-heads divide: head sharding
        assert k[1] == "batch" and k[3] == "model"
    else:           # qwen3's 8 kv-heads do not divide 16: sequence sharding
        assert k[1] == "batch" and k[2] == "model" and k[3] is None
        assert caxes["k"][2] == ("data", "model")
    a1 = R.cache_axes_tree(M.init_cache(get_config("mamba2-1.3b"), 1, 64,
                                        device="meta"))
    assert a1["ssm"][1] is None      # B == 1 -> unsharded batch


AXES = [("batch", None), ("batch", "model", None), (("data", "model"), None),
        ("pod", "data"), ("model", "data"), (("pod", "data"), "model"),
        (None,), ()]


@pytest.mark.parametrize("axis_names", [("data", "model"),
                                        ("pod", "data", "model")],
                         ids=["one_pod", "multi_pod"])
def test_resolve_equals_reference(axis_names):
    sizes = (2,) * len(axis_names)
    jmesh = AbstractMesh(sizes, axis_names)
    pmesh = fake_mesh(**dict(zip(axis_names, sizes)))
    for axes in AXES:
        assert R._resolve(axes, pmesh) == tuple(J._resolve(axes, jmesh))
    batch = R._resolve(("batch",), pmesh)[0]
    assert batch == (("pod", "data") if "pod" in axis_names else "data")
    assert R.placements(R._resolve((("data", "model"), "batch"), pmesh),
                        pmesh)[-2:] == (Shard(0), Shard(0))


def test_act_spec_and_axes_predicate():
    for seq_parallel in (False, True):
        tun = DEFAULT_TUNABLES.replace(seq_parallel=seq_parallel)
        assert R.act_spec(tun) == J.act_spec(
            J_DEFAULT.replace(seq_parallel=seq_parallel))
    for x in [(), (None,), ("data", None), (("data", "model"), None),
              (("model", "data"), ("model", None)), ((None,), (None,)), []]:
        assert R._is_axes(x) == J._is_axes(x), x


def test_host_mesh_twice_and_its_shardings():
    mesh = make_host_mesh("cpu")
    again = make_host_mesh("cpu")
    assert mesh.shape == again.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model") and mesh.backend == "gloo"
    assert mesh.coordinate("model") == 0 and mesh.size == 1
    try:
        R.set_mesh(mesh)
        s = R.named(("batch", "model"))
        assert s.spec == ("data", "model")
        assert s.placements == (Shard(0), Shard(1))
        assert R.named((None,)).placements == (Replicate(), Replicate())
        x = torch.arange(12.0).reshape(3, 4)
        d = R.distribute(x, s)
        assert isinstance(d, DTensor) and torch.equal(d.full_tensor(), x)
        moved = R.maybe_constrain(d, (None, None))
        assert moved.placements == (Replicate(), Replicate())
        assert R.maybe_constrain(x, ("batch",)) is x      # plain: unchanged
    finally:
        R.set_mesh(None)
    assert R.maybe_constrain(d, ("batch",)) is d          # no mesh: as is


def test_int8_state_restores_bitwise_onto_the_host_mesh(tmp_path):
    state = init_train_state(torch.Generator().manual_seed(3), tiny_port(),
                             OptConfig(moments_dtype="int8"),
                             DEFAULT_TUNABLES)
    state["opt"]["count"] = 7
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, state)
    template = init_train_state(torch.Generator().manual_seed(4), tiny_port(),
                                OptConfig(moments_dtype="int8"),
                                DEFAULT_TUNABLES)
    restored, meta = elastic_restore(mgr, template, make_host_mesh("cpu"),
                                     R.state_axes_tree(template))
    R.set_mesh(None)
    assert meta["step"] == 2
    src, dst = _paths(state), _paths(restored)
    for (ka, a), (kb, b) in zip(src, dst):
        assert ka == kb
        if isinstance(a, int):
            assert a == b == 7
        else:
            assert isinstance(b, DTensor) and b.dtype == a.dtype
            assert torch.equal(b.full_tensor(), a), ka
    codes, scales = restored["opt"]["m"]["embed"]
    assert codes.dtype == torch.int8 and codes.placements == (Shard(1), Shard(0))
    assert scales.placements == (Replicate(), Shard(0))   # no data axis


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_devices(multi_pod, n):
    with pytest.raises(RuntimeError, match=f"mesh needs {n} devices, found"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_mesh_checks_its_shape():
    with pytest.raises(RuntimeError, match="mesh needs 4 devices, found 1"):
        make_host_mesh("cpu")                 # a group is live from here on
        make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="does not name its axes"):
        make_mesh((1,), ("data", "model"), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()
    assert np.prod(list(make_host_mesh("cpu").shape.values())) == 1
