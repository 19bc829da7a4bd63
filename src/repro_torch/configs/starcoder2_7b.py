"""starcoder2-7b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]
32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
36 heads do not divide TP=16 -> dp_batch attention."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    rope_theta=100_000.0, mlp_type="gelu", norm_type="layernorm",
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)
