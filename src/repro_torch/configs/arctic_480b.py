"""arctic-480b [moe] — 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000. Dense-MoE hybrid: every layer sums a dense FFN
(d_ff=4864) residual branch with the 128-expert top-2 MoE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    n_experts=128, experts_per_token=2, expert_d_ff=4864,
    dense_residual=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)
