"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
(mistral-nemo). The vision frontend is a STUB: input_specs() provides
n_prefix=1024 precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    rope_theta=1_000_000.0, embeds_input=True, n_prefix=1024,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)
