"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal. [arXiv:2308.11596; hf]
24L (24 enc + 24 dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206
(padded to 256208). The speech frontend is a STUB: input_specs() provides
precomputed frame embeddings for the encoder."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    n_enc_layers=24, n_dec_layers=24,
    rope_theta=0.0, mlp_type="gelu", norm_type="layernorm",
    embeds_input=True,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)
