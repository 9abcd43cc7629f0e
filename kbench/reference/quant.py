"""The control's precision: weights rounded to float8 (e4m3) with one
float32 scale per output channel, the step below the bfloat16 the
configurations state.  Used as the ``cast`` of a reference forward, so
the control is the reference with only its weights coarsened.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_weights(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 and back to float32.  A (d_in, d_out)
    projection is scaled per column (output channel); the embedding, the
    tied head, per row (token)."""
    t = t.float()
    axis = 1 if name == "embed" else 0
    scale = t.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale
