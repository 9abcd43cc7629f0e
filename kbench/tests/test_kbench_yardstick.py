"""The operations and bytes the benchmark counts, against hand counts at
small shapes."""
import pytest

from kbench import yardstick as Y
from kbench.reference import mamba2, qwen2


def test_flash_bound_hand_count():
    # B=1, S=2, H=1, K=1, d=4: 3 visible pairs x 4·d = 48 flops;
    # q, k, v and out once in bf16: 2 bytes x 2 positions x 4 x (2 + 2)
    b = Y.flash_bound(1, 2, 1, 1, 4)
    assert b["flops"] == 48
    assert b["bytes"] == 2 * 2 * 4 * 4
    assert b["bound_s"] == max(64 / Y.PEAK_BYTES_S, 48 / Y.PEAK_BF16_FLOPS)


def test_ssd_bound_hand_count():
    # B=1, S=Q=2, H=1, P=1, G=1, N=1: one chunk; C·Bᵀ 2·4·1 = 8;
    # scores x 3·(2 + 3) = 15; state 4·2·1·1 = 8
    b = Y.ssd_bound(1, 2, 1, 1, 1, 1, 2)
    assert b["flops"] == 8 + 15 + 8
    # x, B, C bf16 (2·(2 + 4)) + dt fp32 (8) + A (4) + y fp32 (8) + state (4)
    assert b["bytes"] == 12 + 8 + 4 + 8 + 4


@pytest.mark.parametrize("S,chunk,Q", [(4096, 256, 256), (128, 256, 128),
                                       (96, 64, 32), (48, 16, 16)])
def test_ssd_chunk(S, chunk, Q):
    assert Y.ssd_chunk(S, chunk) == Q


DENSE = {"family": "dense", "d": 4, "layers": 2, "vocab": 10,
         "vocab_padded": 16, "heads": 2, "kv_heads": 1, "head_dim": 2,
         "ff": 6}
SSM = {"family": "ssm", "d": 4, "layers": 1, "vocab": 10, "vocab_padded": 16,
       "d_inner": 8, "ssm_heads": 2, "ssm_head_dim": 4, "d_state": 3,
       "groups": 1, "d_conv": 4}


def test_layer_params_hand_count():
    # wq 4·4 + wk, wv 2·(4·2) + wo 4·4 + mlp 3·4·6 = 120
    assert qwen2.layer_params(DENSE) == 120
    # in_proj 4·(16 + 6 + 2) = 96, out_proj 8·4 = 32
    assert mamba2.layer_params(SSM) == 96 + 32


def test_dense_call_flops_hand_count():
    # prefill B=1, S=3: body 2·240·3, the head (4·16) at the last position,
    # attention 4·2·2·2 per visible pair x 6 pairs
    pf = 2 * 240 * 3 + 2 * 64 + 32 * 6
    assert qwen2.call_flops(DENSE, 1, 3, 0) == pf
    # decode at pos 3 then 4: all 304 parameters, 4 then 5 keys visible
    assert qwen2.call_flops(DENSE, 1, 3, 2) == pf + (2 * 304 + 32 * 4) + \
        (2 * 304 + 32 * 5)
    assert qwen2.call_flops(DENSE, 2, 3, 0) == 2 * pf


def test_ssm_call_flops_hand_count():
    scan = Y.ssd_bound(2, 4, 2, 4, 1, 3, 4)["flops"]
    pf = 2 * 128 * 8 + 2 * 64 * 2 + scan
    assert mamba2.call_flops(SSM, 2, 4, 0, 256) == pf
    # two decode steps of 2 tokens: 192 parameters and 4·2·3·4 state each
    assert mamba2.call_flops(SSM, 2, 4, 2, 256) == pf + 2 * 2 * (
        2 * 192 + 4 * 2 * 3 * 4)


def test_dims_from_the_config_files():
    import json
    from kbench.tests.tiny import REPO
    q = qwen2.dims(json.loads((REPO / "kbench/configs/qwen2-1.5b.json")
                              .read_text()))
    assert (q["d"], q["layers"], q["heads"], q["kv_heads"], q["head_dim"],
            q["ff"], q["vocab_padded"]) == (1536, 28, 12, 2, 128, 8960,
                                             152064)
    # 1.54e9 parameters, the tied head counted once
    n = q["layers"] * qwen2.layer_params(q) + q["d"] * q["vocab_padded"]
    assert abs(n - 1.5436e9) / 1.5436e9 < 1e-3
    m = mamba2.dims(json.loads((REPO / "kbench/configs/mamba2-1.3b.json")
                               .read_text()))
    assert (m["d"], m["layers"], m["d_inner"], m["ssm_heads"], m["d_state"],
            m["vocab_padded"]) == (2048, 48, 4096, 64, 128, 50432)
