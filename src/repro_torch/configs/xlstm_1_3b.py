"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]
48L d_model=2048 4H vocab=50304, d_ff=0 (projection factor inside blocks).
Pattern: xLSTM[7:1] — 7 mLSTM : 1 sLSTM, repeated 6x. Attention-free ->
runs the long_500k cell with O(1) state."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
    mlstm_chunk=64, rope_theta=0.0,
    param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
)
