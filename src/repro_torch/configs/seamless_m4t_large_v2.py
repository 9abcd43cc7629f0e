"""seamless-m4t-large-v2 — enc-dec multimodal backbone [arXiv:2308.11596].

Speech frontend is a STUB (precomputed frame embeddings). 24L assigned budget
split 12 encoder / 12 decoder (DESIGN.md §Open assumptions).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, frontend="audio_stub",
)
