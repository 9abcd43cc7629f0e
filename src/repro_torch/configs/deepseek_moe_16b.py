"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6 [arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  first_layer_dense=True),
)
