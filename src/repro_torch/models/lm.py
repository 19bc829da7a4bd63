"""Decoder-only LM covering the dense, MoE and VLM families, in PyTorch.

The counterpart of the reference's `repro/models/lm.py`: yi-6b,
phi3-medium-14b, granite-3-2b, starcoder2-7b (dense GQA), qwen2-moe-a2.7b
and arctic-480b (MoE, `models/moe.py`; a parallel MLP branch at
``shared_expert_d_ff``, qwen2-moe's shared expert, or at ``d_ff``,
arctic's dense residual), and pixtral-12b (the decoder backbone whose
first ``embeds.shape[1]`` positions take precomputed patch embeddings from
the stubbed vision frontend). Parameters are ``{"embed": [Vp, d],
"layers": [per-layer dict, ...], "norm": {...}}``: the reference's
layer-stacked leaves ``[L, ...]`` become one dictionary per layer, and its
`lax.scan` over layers a Python loop. The other families have modules of
their own (`models/registry.py`), and this module's functions refuse them
(`_check_lm`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partitioning
from repro_torch.sharding.policy import Policy

#: the families this module runs (the reference's `registry.FAMILIES`
#: maps each to `lm`)
LM_FAMILIES = ("dense", "moe", "vlm")
#: keys of the parameter tree whose per-layer list the reference stacks
#: along a leading axis (its ``[L, ...]`` leaves)
STACKED_KEYS = ("layers",)


class DecodeCache(NamedTuple):
    k: torch.Tensor       # [Lyr, B, T, KVr, hd]
    v: torch.Tensor       # [Lyr, B, T, KVr, hd]
    pos: int              # next absolute position


def _check_lm(cfg: ModelConfig):
    """This module's functions run the families of `LM_FAMILIES` only."""
    if cfg.family not in LM_FAMILIES:
        raise ValueError(f"{cfg.name}: models/lm.py runs the dense family "
                         f"and its moe and vlm branches, not "
                         f"{cfg.family!r}; take the family's module from "
                         f"models.registry.get_family")


def _parallel_ff(cfg: ModelConfig) -> int:
    """Width of an MoE layer's parallel MLP branch (0: none)."""
    return cfg.shared_expert_d_ff or (cfg.d_ff if cfg.dense_residual else 0)


def _layer_init(gen: torch.Generator, cfg: ModelConfig, pol: Policy):
    dev = gen.device
    p = {
        "ln1": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type, dev),
        "attn": L.attn_init(gen, cfg),
        "ln2": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type, dev),
    }
    if cfg.n_experts:
        p["moe"] = moe_lib.moe_init(gen, cfg, pol)
        if _parallel_ff(cfg):
            p["mlp"] = L.mlp_init(gen, cfg, d_ff=_parallel_ff(cfg))
    else:
        p["mlp"] = L.mlp_init(gen, cfg)
    return p


def init_params(cfg: ModelConfig, pol: Policy, gen: torch.Generator):
    """Random parameters on `gen`'s device, drawn from `gen` in a fixed
    order (embedding, then layer by layer)."""
    _check_lm(cfg)
    embed = L.embed_init(gen, L.padded_vocab(cfg), cfg.d_model, cfg.pdtype())
    return {
        "embed": embed,
        "layers": [_layer_init(gen, cfg, pol) for _ in range(cfg.n_layers)],
        "norm": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type,
                            gen.device),
    }


def _layer_axes(cfg: ModelConfig) -> dict:
    p = {"ln1": L.norm_axes(cfg.norm_type), "attn": L.attn_axes(),
         "ln2": L.norm_axes(cfg.norm_type)}
    if cfg.n_experts:
        p["moe"] = moe_lib.moe_axes()
        if _parallel_ff(cfg):
            p["mlp"] = L.mlp_axes(cfg)
    else:
        p["mlp"] = L.mlp_axes(cfg)
    return p


def param_axes(cfg: ModelConfig, pol: Policy) -> dict:
    """The logical axes of every leaf of `init_params`' tree (the
    reference's `Boxed` axes without the leading "layers")."""
    _check_lm(cfg)
    return {"embed": L.EMBED_AXES,
            "layers": [_layer_axes(cfg) for _ in range(cfg.n_layers)],
            "norm": L.norm_axes(cfg.norm_type)}


def _ffn(cfg: ModelConfig, pol: Policy, p, h, aux: bool = True):
    """The block's feed-forward part: (out, MoE aux loss; None without
    `aux`)."""
    if not cfg.n_experts:
        return L.mlp_forward(p["mlp"], cfg, pol, h), 0.0
    mo, aux = moe_lib.moe_forward(p["moe"], cfg, pol, h, impl=cfg.moe_impl,
                                  aux=aux)
    if "mlp" in p:
        mo = mo + L.mlp_forward(p["mlp"], cfg, pol, h)
    return mo, aux


def _block(cfg: ModelConfig, pol: Policy, p, x, positions):
    """One pre-norm transformer block. Returns (x, aux_loss, (k, v)). On a
    mesh whose policy shards weights over ZeRO-3's axes (training under
    ``tp``), the block's weights are first gathered whole there
    (`Policy.at_use`)."""
    p = pol.at_use(p)
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps, cfg.norm_type)
    a, kv = L.attn_forward(p["attn"], cfg, pol, h, positions,
                           window=cfg.local_window)
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm_eps, cfg.norm_type)
    f, aux = _ffn(cfg, pol, p, h)
    return pol.constrain(x + f, "batch", "seq", None), aux, kv


def embed_tokens(cfg: ModelConfig, pol: Policy, params, tokens,
                 embeds: Optional[torch.Tensor] = None):
    """Token embedding, in the compute dtype. For a VLM backbone the first
    ``embeds.shape[1]`` positions come from the (stubbed) modality
    frontend instead of the table; `embeds` is cast to the table's dtype
    first, then with the rest to the compute dtype, as the reference casts
    it. On a mesh, a table sharded over the vocabulary gives each rank the
    rows it holds, and the constraint sums them (an all-reduce). With a
    prefix, the lookup is summed before the splice: a partial sum of rows
    does not concatenate with the whole embeddings (DTensor refuses it),
    and the one all-reduce stays the only one. In the backward (a train
    step on a mesh, under ``tp``, ``dp_zero1`` or ``dp_zero3``) the splice
    gives the prefix positions' rows of the lookup no gradient, and
    `embeds`, an input, none."""
    x = F.embedding(tokens, params["embed"])
    if embeds is not None:
        n = embeds.shape[1]
        x = pol.constrain(x, "batch", "seq", None)
        x = torch.cat([embeds.to(x.dtype), x[:, n:]], dim=1)
    x = pol.constrain(x.to(cfg.cdtype()), "batch", "seq", None)
    # the backward of a vocabulary-sharded lookup takes a whole gradient
    return partitioning.grad_placed(x)


def forward(cfg: ModelConfig, pol: Policy, params, tokens,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None):
    """Full-sequence forward (train / prefill).

    Returns (hidden [B,S,d] post-final-norm, aux_loss): the MoE layers'
    load-balance losses summed, times ``router_aux_loss / n_layers`` (0
    for a dense model). With ``cfg.remat != "none"`` and gradients on,
    each block runs under `torch.utils.checkpoint` and is recomputed in
    the backward, as the reference's scanned body runs under
    `jax.checkpoint`: the attention kernel launches twice a layer a step.
    """
    _check_lm(cfg)
    B, S = tokens.shape
    x = embed_tokens(cfg, pol, params, tokens, embeds)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]

    def body(x, lp):
        x, a, _ = _block(cfg, pol, lp, x, positions)
        return x, a

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        # nothing in a block draws random numbers: no RNG state to replay
        x, a = (checkpoint(body, x, lp, use_reentrant=False,
                           preserve_rng_state=False) if remat
                else body(x, lp))
        aux = aux + a
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    return x, aux * cfg.router_aux_loss / max(cfg.n_layers, 1)


def prefill(cfg: ModelConfig, pol: Policy, params, tokens, max_len: int,
            embeds: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16):
    """Forward over the prompt, returning (hidden, seeded DecodeCache).

    Each layer's K/V, rounded to `cache_dtype`, seed a cache of length
    ``max_len`` (ring-truncated to the local window if the arch has one).
    An MoE layer routes the prompt at the capacity of its length S, so a
    prefill may drop choices that a full forward of another length would
    keep.
    """
    _check_lm(cfg)
    B, S = tokens.shape
    x = embed_tokens(cfg, pol, params, tokens, embeds)
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
        x, _, (k, v) = _block(cfg, pol, lp, x, positions)
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


def cache_axes(cfg: ModelConfig) -> DecodeCache:
    """The logical axes of `init_cache`'s tensors, the reference's
    (`lm.py:178-180`): "layers" first, as both stack the layers."""
    ax = ("layers", "batch", "cache_seq", "kv_heads", None)
    return DecodeCache(k=ax, v=ax, pos=())


def decode_step(cfg: ModelConfig, pol: Policy, params, cache: DecodeCache,
                tokens):
    """One decode step. tokens: [B, 1]. Returns (logits [B,1,V], cache):
    the cache's tensors are updated in place and returned with ``pos + 1``.
    """
    _check_lm(cfg)
    x = embed_tokens(cfg, pol, params, tokens)
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(lp["ln1"], x, cfg.norm_eps, cfg.norm_type)
        a, _, _ = L.attn_decode(lp["attn"], cfg, pol, h, cache.k[i],
                                cache.v[i], cache.pos,
                                window=cfg.local_window)
        x = x + a
        h = L.apply_norm(lp["ln2"], x, cfg.norm_eps, cfg.norm_type)
        # the aux loss is not read: skipped, as XLA drops it (on a mesh it
        # would take a collective of its own)
        x = x + _ffn(cfg, pol, lp, h, aux=False)[0]
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    logits = L.unembed(cfg, pol, x, params["embed"])
    return logits, cache._replace(pos=cache.pos + 1)
