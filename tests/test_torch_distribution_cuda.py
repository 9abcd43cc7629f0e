"""The distributed runtime on the card: the host mesh is a world of one
under NCCL, a train state restores onto it, and a tiny qwen2 Trainer on
it (flash attention's kernel in every layer) trains bit-equal to one
without a mesh.  Marked ``cuda``: skips where there is no GPU.  Imports
no JAX:

    python -m pytest -q -m cuda tests/test_torch_distribution_cuda.py
"""
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import DEFAULT_TUNABLES, ShapeSpec, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import OptConfig, tree_leaves
from repro_torch.runtime.checkpoint import CheckpointManager, _paths
from repro_torch.runtime.fault import elastic_restore
from repro_torch.runtime.loop import Trainer
from repro_torch.sharding import rules
from repro_torch.train.step import init_train_state

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def one_rank_group():
    """Closes the NCCL group the host mesh started, after the module."""
    yield
    if torch.distributed.is_initialized() and \
            torch.distributed.get_backend() == "nccl":
        torch.distributed.destroy_process_group()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    return torch.device("cuda")


def _cfg():
    return reduced(get_config("qwen2-1.5b")).replace(n_layers=2, vocab=256)


def test_host_mesh_is_nccl(cuda_device):
    mesh = make_host_mesh()
    assert mesh.device.type == "cuda" and mesh.backend == "nccl"
    assert mesh.shape == {"data": 1, "model": 1}
    assert make_host_mesh().shape == mesh.shape          # again: no error


def test_elastic_restore_onto_the_card_mesh(cuda_device, tmp_path):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = init_train_state(gen, _cfg(), OptConfig(moments_dtype="int8"),
                             DEFAULT_TUNABLES)
    mgr = CheckpointManager(tmp_path)
    mgr.save(4, state)
    restored, meta = elastic_restore(mgr, state, make_host_mesh(),
                                     rules.state_axes_tree(state))
    rules.set_mesh(None)
    assert meta["step"] == 4
    for (ka, a), (kb, b) in zip(_paths(state), _paths(restored)):
        assert ka == kb
        if isinstance(a, int):
            assert a == b
            continue
        assert isinstance(b, DTensor) and b.device.type == "cuda"
        assert torch.equal(b.full_tensor(), a), ka


def test_trainer_on_the_card_mesh_equals_no_mesh(cuda_device):
    tun = DEFAULT_TUNABLES.replace(attn_impl="pallas")
    shape = ShapeSpec("t", 64, 2, "train")
    runs = {}
    for mesh in (make_host_mesh(), None):
        FA.LAUNCHES = 0
        tr = Trainer(_cfg(), shape, OptConfig(lr=1e-3, warmup=0), tun,
                     mesh=mesh)
        assert rules.current_mesh() is mesh
        try:
            rep = tr.run(2)
        finally:
            tr.pipeline.close()
        assert FA.LAUNCHES > 0
        runs[mesh is None] = (rep.losses, [p.clone() for p in tree_leaves(
            tr.state["params"])])
    assert runs[False][0] == runs[True][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[False][1],
                                                 runs[True][1]))
