"""The launch tooling's check on the card: ``verify_budget``'s real step
(``dryrun.CardCell``) on reduced qwen2-1.5b with ``attn_impl="pallas"``
measures a temporary size above 0 and launches the flash kernel; a
candidate that runs out of memory (forced here with a memory cap) is
recorded as ``oom`` and the next one runs; and ``verify_budget.main
--card`` walks a stored trace to a chosen candidate with its step
seconds.  Marked ``cuda``: skips where there is no GPU.  Imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_launch_cuda.py
"""
import json

import pytest
import torch

from repro_torch.configs.base import ShapeSpec, Tunables, reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun as D
from repro_torch.launch import verify_budget as VB

pytestmark = pytest.mark.cuda

TUN = Tunables(attn_impl="pallas")
SHAPE = ShapeSpec("t", 128, 4, "train")


@pytest.fixture(scope="module", autouse=True)
def one_rank_group():
    """Closes the NCCL group the host mesh started, after the module."""
    yield
    if torch.distributed.is_initialized() and \
            torch.distributed.get_backend() == "nccl":
        torch.distributed.destroy_process_group()


@pytest.fixture
def cell():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    c = D.CardCell(reduced(get_config("qwen2-1.5b")), SHAPE, device="cuda")
    yield c
    c.close()


def test_step_measures_temp_and_launches_flash(cell):
    FA.LAUNCHES = 0
    rec = cell.run(TUN)
    assert not rec["oom"], rec
    assert rec["temp_source"] == "torch.cuda.max_memory_allocated"
    assert rec["temp_size_in_bytes"] > 0 and rec["step_s"] > 0
    # two steps, each layer's forward and its remat recompute through the
    # kernel
    assert TUN.remat != "none" and TUN.microbatches == 1
    assert FA.LAUNCHES == 2 * 2 * cell.cfg.n_layers


def test_out_of_memory_is_recorded_and_the_walk_goes_on(cell):
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = (torch.cuda.memory_reserved() + 2 ** 20) / total
    torch.cuda.set_per_process_memory_fraction(cap)
    try:
        rec = cell.run(TUN)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert rec["oom"] and rec["temp_size_in_bytes"] is None, rec
    assert not cell.run(TUN)["oom"]


def test_verify_budget_card_walk(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    small = reduced(get_config("qwen2-1.5b"))
    monkeypatch.setattr(VB, "get_config", lambda name: small)
    monkeypatch.setattr(VB, "card_shape", lambda shape: SHAPE)
    monkeypatch.setattr(VB, "OUT_ROOT", tmp_path)
    trace = [{"tun": TUN.replace(remat=r).as_dict(), "est_s": e}
             for r, e in (("none", 1e-3), ("dots", 2e-3))]
    path = tmp_path / "1x1" / "qwen2-1.5b__train_4k__opt.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"hillclimb": {"baseline": trace[1],
                                              "trace": trace}}))
    rec = VB.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                   "--card"])
    budgeted = rec["hillclimb"]["budgeted"]
    assert budgeted["tun"]["remat"] == "none"
    assert budgeted["temp_bytes"] > 0 and budgeted["step_s"] > 0
    assert budgeted["est_over_step"] == 1e-3 / budgeted["step_s"]
    assert budgeted["roofline"]["compute_s"] > 0
