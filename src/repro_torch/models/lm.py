"""Decoder-only LM of the dense family (yi-6b, phi3-medium-14b,
granite-3-2b, starcoder2-7b), in PyTorch.

The counterpart of the reference's `repro/models/lm.py` for ``n_experts ==
0``. Parameters are ``{"embed": [Vp, d], "layers": [per-layer dict, ...],
"norm": {...}}``: the reference's layer-stacked leaves ``[L, ...]`` become
one dictionary per layer, and its `lax.scan` over layers a Python loop.
The MoE branch and the other families raise `NotImplementedError` naming
their ROADMAP.md item (`check_ported`); the hybrid family has its own
module (`models/hybrid.py`), and this module's functions refuse it
(`_check_dense`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import Policy

#: families of the reference that the port does not have yet -> their item
UNPORTED_FAMILIES = {
    "moe": "ROADMAP.md Queue 1 item 11 (MoE family)",
    "vlm": "ROADMAP.md Queue 1 item 12 (VLM backbone)",
    "ssm": "ROADMAP.md Queue 1 item 13 (xLSTM family)",
    "encdec": "ROADMAP.md Queue 1 item 14 (encoder-decoder family)",
}
#: keys of the parameter tree whose per-layer list the reference stacks
#: along a leading axis (its ``[L, ...]`` leaves)
STACKED_KEYS = ("layers",)


class DecodeCache(NamedTuple):
    k: torch.Tensor       # [Lyr, B, T, KVr, hd]
    v: torch.Tensor       # [Lyr, B, T, KVr, hd]
    pos: int              # next absolute position


def check_ported(cfg: ModelConfig):
    """Raises unless the port has `cfg`'s family: dense (this module) or
    hybrid (`models/hybrid.py`). The port's one refusal of the families it
    does not have yet."""
    family = "moe" if cfg.n_experts else cfg.family
    if family in ("dense", "hybrid"):
        return
    if family not in UNPORTED_FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    raise NotImplementedError(
        f"{cfg.name}: family {family!r} is not ported yet "
        f"({UNPORTED_FAMILIES[family]})")


def _check_dense(cfg: ModelConfig):
    """This module's functions run the dense family only."""
    check_ported(cfg)
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: models/lm.py runs the dense family, "
                         f"not {cfg.family!r}; take the family's module from "
                         f"models.registry.get_family")


def _layer_init(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    return {
        "ln1": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type, dev),
        "attn": L.attn_init(gen, cfg),
        "ln2": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type, dev),
        "mlp": L.mlp_init(gen, cfg),
    }


def init_params(cfg: ModelConfig, pol: Policy, gen: torch.Generator):
    """Random parameters on `gen`'s device, drawn from `gen` in a fixed
    order (embedding, then layer by layer)."""
    _check_dense(cfg)
    embed = L.embed_init(gen, L.padded_vocab(cfg), cfg.d_model, cfg.pdtype())
    return {
        "embed": embed,
        "layers": [_layer_init(gen, cfg) for _ in range(cfg.n_layers)],
        "norm": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type,
                            gen.device),
    }


def _block(cfg: ModelConfig, pol: Policy, p, x, positions):
    """One pre-norm transformer block. Returns (x, (k, v))."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps, cfg.norm_type)
    a, kv = L.attn_forward(p["attn"], cfg, pol, h, positions,
                           window=cfg.local_window)
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm_eps, cfg.norm_type)
    return x + L.mlp_forward(p["mlp"], cfg, pol, h), kv


def embed_tokens(cfg: ModelConfig, pol: Policy, params, tokens):
    """Token embedding, in the compute dtype. (The reference's VLM
    `embeds` input belongs to the VLM backbone, ROADMAP.md Queue 1.)"""
    return params["embed"][tokens].to(cfg.cdtype())


def forward(cfg: ModelConfig, pol: Policy, params, tokens):
    """Full-sequence forward (train / prefill).

    Returns (hidden [B,S,d] post-final-norm, aux_loss); the aux loss of a
    dense model is 0.
    """
    _check_dense(cfg)
    B, S = tokens.shape
    x = embed_tokens(cfg, pol, params, tokens)
    positions = torch.arange(S, device=x.device)[None, :]
    for lp in params["layers"]:
        x, _ = _block(cfg, pol, lp, x, positions)
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(cfg: ModelConfig, pol: Policy, params, tokens, max_len: int,
            cache_dtype=torch.bfloat16):
    """Forward over the prompt, returning (hidden, seeded DecodeCache).

    Each layer's K/V, rounded to `cache_dtype`, seed a cache of length
    ``max_len`` (ring-truncated to the local window if the arch has one).
    """
    _check_dense(cfg)
    B, S = tokens.shape
    x = embed_tokens(cfg, pol, params, tokens)
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_cache(cfg, pol, B, max_len, cache_dtype, device=x.device)
    T = cache.k.shape[2]
    take = min(S, T)
    # write the last `take` prompt positions; ring layout if windowed
    if cfg.local_window and T == cfg.local_window:
        idx = torch.arange(S - take, S, device=x.device) % T
    else:
        idx = slice(0, take)
    for i, lp in enumerate(params["layers"]):
        x, (k, v) = _block(cfg, pol, lp, x, positions)
        cache.k[i][:, idx] = k[:, S - take:].to(cache_dtype)
        cache.v[i][:, idx] = v[:, S - take:].to(cache_dtype)
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    return x, cache._replace(pos=S)


def init_cache(cfg: ModelConfig, pol: Policy, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> DecodeCache:
    kvr = cfg.n_kv_heads * pol.kv_repeat
    T = min(max_len, cfg.local_window) if cfg.local_window else max_len
    shape = (cfg.n_layers, batch, T, kvr, cfg.hd)
    return DecodeCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       pos=0)


def decode_step(cfg: ModelConfig, pol: Policy, params, cache: DecodeCache,
                tokens):
    """One decode step. tokens: [B, 1]. Returns (logits [B,1,V], cache):
    the cache's tensors are updated in place and returned with ``pos + 1``.
    """
    _check_dense(cfg)
    x = embed_tokens(cfg, pol, params, tokens)
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(lp["ln1"], x, cfg.norm_eps, cfg.norm_type)
        a, _, _ = L.attn_decode(lp["attn"], cfg, pol, h, cache.k[i],
                                cache.v[i], cache.pos,
                                window=cfg.local_window)
        x = x + a
        h = L.apply_norm(lp["ln2"], x, cfg.norm_eps, cfg.norm_type)
        x = x + L.mlp_forward(lp["mlp"], cfg, pol, h)
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    logits = L.unembed(cfg, pol, x, params["embed"])
    return logits, cache._replace(pos=cache.pos + 1)
