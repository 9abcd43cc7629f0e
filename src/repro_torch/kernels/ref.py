"""Plain PyTorch oracles for every hand-written kernel (the allclose
targets).

Port of ``repro/kernels/ref.py``:

flash_attention -> models.layers.attention_xla (chunked masked GQA)
ssd_scan        -> models.mamba2.ssd_chunked
pairdist        -> pairdist.ref_pairdist
"""
import torch

from repro_torch.kernels.pairdist import (ref_adjacency, ref_neighbor_count,
                                          ref_pairdist)
from repro_torch.models.layers import attention_xla
from repro_torch.models.mamba2 import ssd_chunked


def attention_ref(q, k, v, *, causal=True, window=None, softcap=0.0):
    return attention_xla(q, k, v,
                         q_pos=torch.arange(q.shape[1], device=q.device),
                         kv_pos=torch.arange(k.shape[1], device=k.device),
                         causal=causal, window=window, softcap=softcap,
                         q_chunk=max(q.shape[1], 1))


def ssd_ref(x, dt, A, Bm, Cm, chunk=256):
    y, s = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    return y.to(torch.float32), s


__all__ = ["attention_ref", "ssd_ref", "ref_pairdist", "ref_neighbor_count",
           "ref_adjacency"]
