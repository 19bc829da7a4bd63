"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936. Shared-expert branch = 4 x 1408 = 5632 (HF
shared_expert_intermediate_size).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    n_experts=60, experts_per_token=4, expert_d_ff=1408,
    shared_expert_d_ff=5632,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)
