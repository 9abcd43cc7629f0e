"""gemma2-9b — local/global alternating attention + logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab=256000,
    attn_softcap=50.0, final_softcap=30.0,
    window=4096, window_pattern="alternating",
    scale_embed=True,
)
