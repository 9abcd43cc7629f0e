"""paligemma-3b — gemma backbone + SigLIP stub frontend [arXiv:2407.07726].

The vision tower is a STUB: input_specs() provides 256 precomputed patch
embeddings; a prefix-LM mask makes image+prefix bidirectional.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216,
    num_patches=256, frontend="vision_stub",
    scale_embed=True,
)
