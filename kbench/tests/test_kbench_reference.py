"""The plain references agree with the program where both run in float32
on the CPU, and the plain DBSCAN with the program's."""
import json

import numpy as np
import pytest
import torch

from kbench import weights
from kbench.reference import dbscan as ref_dbscan
from kbench.reference import mamba2 as ref_mamba2
from kbench.reference import qwen2 as ref_qwen2
from kbench.tests import tiny


@pytest.mark.parametrize("family,ref", [("qwen2", ref_qwen2),
                                        ("mamba2", ref_mamba2)])
def test_reference_matches_the_program_in_float32(family, ref):
    from repro_torch.configs.base import Tunables
    from repro_torch.models import model as M
    from kbench import harness
    cfg = tiny.tiny_config(family)
    cfg["torch_dtype"] = "float32"
    cfg["program"]["replace"]["dtype"] = "float32"
    if family == "mamba2":
        cfg["ssm_cfg"]["chunk_size"] = 16
        cfg["program"]["replace"]["ssm"]["chunk"] = 16
    m = ref.dims(cfg)
    pc = harness.program_config(cfg, ref)
    gen = torch.Generator().manual_seed(4)
    w = weights.make_weights(ref.leaves(m, torch.float32), gen)
    tok = torch.randint(0, m["vocab"], (2, 48), generator=gen)
    tun = Tunables(attn_impl="pallas", ssm_chunk=16)
    got = M.forward(w, pc, {"tokens": tok.to(torch.int32)}, tun)[0]
    for b in range(2):
        want = ref.run(w, m, tok[b])
        torch.testing.assert_close(got[b], want, rtol=1e-4, atol=1e-4)


def test_plain_dbscan_matches_the_programs():
    from repro_torch.core.dbscan import dbscan
    rng = np.random.default_rng(0)
    for n in (1, 5, 40, 130):
        x = rng.normal(size=(n, 16)).astype(np.float32) * 0.2
        x[: n // 2] += 1.0
        for eps, k in ((0.35, 4), (0.6, 3), (0.9, 5)):
            np.testing.assert_array_equal(
                ref_dbscan.labels(x, eps, k),
                dbscan(x, eps, k, device="cpu"))


def test_config_files_hold_their_sources_widths():
    from kbench.tests.tiny import REPO
    from kbench import harness
    for name, ref in (("qwen2-1.5b", ref_qwen2), ("mamba2-1.3b", ref_mamba2)):
        cfg = json.loads((REPO / "kbench" / "configs" / f"{name}.json")
                         .read_text())
        assert harness.program_config(cfg, ref).name == name
