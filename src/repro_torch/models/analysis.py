"""Analytic parameter and size models, shared by the sharding-policy
resolver (napkin math for strategy selection) and the dry run.

The counterpart of the reference's `repro/models/analysis.py`
(`analysis.py:10-75`), expression for expression: the counts are floats
summed in the reference's order, so that they equal its values exactly.
"""
from __future__ import annotations

import math

from repro_torch.models.config import ModelConfig


def pad16(v: int) -> int:
    return math.ceil(v / 16) * 16


def family_counts(cfg: ModelConfig):
    """(n_attn_layers, n_rec_layers, n_mlstm, n_slstm)."""
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        reps, tail = divmod(cfg.n_layers, len(pat))
        seq = list(pat) * reps + list(pat[:tail])
        return (sum(1 for t in seq if t == "attn"),
                sum(1 for t in seq if t == "rec"), 0, 0)
    if cfg.family == "ssm":
        pat = cfg.xlstm_pattern or ("m",)
        reps = cfg.n_layers // len(pat)
        return (0, 0, reps * sum(1 for t in pat if t == "m"),
                reps * sum(1 for t in pat if t == "s"))
    return cfg.n_layers, 0, 0, 0


def param_count(cfg: ModelConfig, expert_pad: int = 0) -> float:
    """Element count, matching the models' init functions (tied
    embeddings)."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    n_attn, n_rec, n_m, n_s = family_counts(cfg)
    P = pad16(cfg.vocab_size) * d
    per_attn = d * (H + 2 * KV) * hd + H * hd * d
    if cfg.family == "encdec":
        ff_n = 2 if cfg.mlp_type == "gelu" else 3
        P += (cfg.n_enc_layers + cfg.n_dec_layers) * \
            (per_attn + ff_n * d * cfg.d_ff)
        P += cfg.n_dec_layers * per_attn
        return float(P)
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import _slstm_ff
        di = 2 * d
        dh = di // H
        P += n_m * (2 * d * di + 3 * H * dh * dh + di * d + di * 2 * H)
        P += n_s * (4 * d * d + 4 * d * (d // H) + 3 * d * _slstm_ff(d))
        return float(P)
    dr = cfg.d_rnn or d
    P += n_attn * per_attn
    P += n_rec * (3 * d * dr + 2 * dr * dr)
    ff_n = 2 if cfg.mlp_type == "gelu" else 3
    if cfg.n_experts:
        E = expert_pad or cfg.n_experts
        P += cfg.n_layers * (d * E + E * 3 * d * cfg.expert_d_ff)
        par_ff = cfg.shared_expert_d_ff or (cfg.d_ff if cfg.dense_residual
                                            else 0)
        if par_ff:
            P += cfg.n_layers * 3 * d * par_ff
    else:
        P += cfg.n_layers * ff_n * d * cfg.d_ff
    return float(P)


def active_param_count(cfg: ModelConfig) -> float:
    """Active path (MoE: top-k experts instead of all)."""
    if not cfg.n_experts:
        return param_count(cfg)
    full = param_count(cfg, cfg.n_experts)
    all_exp = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.expert_d_ff
    return full - all_exp * (1 - cfg.experts_per_token / cfg.n_experts)


def param_dtype_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.param_dtype == "bfloat16" else 4
