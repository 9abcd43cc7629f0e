"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 SSD layers; one shared attention+MLP block applied every 6 layers with
per-invocation LoRA (rank 64). ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2),
    hybrid_period=6, lora_rank=64,
)
