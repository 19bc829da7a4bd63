"""Model configuration, the same dataclass as the reference's
`repro/models/config.py`; `pdtype()` / `cdtype()` return torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0
    shared_expert_d_ff: int = 0               # qwen2-moe shared expert
    dense_residual: bool = False              # arctic: dense MLP + MoE residual
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    moe_impl: str = "auto"        # auto | gather | einsum (GShard ref).
    # hybrid (recurrentgemma): repeating block pattern, e.g. ("rec","rec","attn")
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 0                     # local attention window (0 = full)
    d_rnn: int = 0                            # RG-LRU recurrence width
    conv_width: int = 4
    # ssm (xlstm): pattern of mLSTM/sLSTM blocks
    xlstm_pattern: Tuple[str, ...] = ()
    mlstm_chunk: int = 64
    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # modality frontend stubs feed the backbone with precomputed embeddings
    embeds_input: bool = False                # vlm / audio-encoder input
    n_prefix: int = 0                         # vlm: patch-embedding positions
    # block flavour
    mlp_type: str = "swiglu"                  # swiglu | gelu
    norm_type: str = "rmsnorm"                # rmsnorm | layernorm
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # remat: "none" | "full" | "dots"  (activation checkpointing policy)
    remat: str = "none"
    # attention implementation: "xla" (the plain chunked path) | "pallas"
    # (the flash-attention kernel: CUDA on the card, its plain version on
    # the CPU). The names are the reference's.
    attention_impl: str = "xla"
    logit_softcap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, len(cfg.block_pattern) or
                     len(cfg.xlstm_pattern) or 2),
        d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16, d_ff=128, vocab_size=251,      # odd: exercises pad mask
        param_dtype="float32", compute_dtype="float32", remat="none")
    if cfg.family == "moe":
        kw.update(n_experts=4, experts_per_token=min(2, cfg.experts_per_token),
                  expert_d_ff=64,
                  shared_expert_d_ff=64 if cfg.shared_expert_d_ff else 0)
    if cfg.family == "hybrid":
        kw.update(n_layers=len(cfg.block_pattern) + 1 or 3, d_rnn=64,
                  local_window=16)   # +1 layer exercises the unrolled tail
    if cfg.family == "ssm":
        kw.update(n_layers=len(cfg.xlstm_pattern) or 2, mlstm_chunk=8)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, n_dec_layers=2)
    if cfg.embeds_input and cfg.n_prefix:
        kw.update(n_prefix=4)
    kw.update(overrides)
    return cfg.with_(**kw)
