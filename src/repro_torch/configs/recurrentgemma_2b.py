"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2. [arXiv:2402.19427; hf]
26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, lru width 2560,
window 2048, pattern (rec, rec, attn) cycled (26 = 8*3 + 2)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), local_window=2048, d_rnn=2560,
    conv_width=4, rope_theta=10_000.0, mlp_type="gelu",
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)
