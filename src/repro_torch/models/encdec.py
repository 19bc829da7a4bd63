"""Encoder-decoder backbone (seamless-m4t-large-v2), in PyTorch.

The counterpart of the reference's `repro/models/encdec.py`: the
transformer backbone only. The speech frontend is a stub there and here:
the encoder takes precomputed frame embeddings ``[B, S_enc, d]``
(``embeds``). Encoder: bidirectional self-attention blocks. Decoder: causal
self-attention, cross attention over the encoder's memory, MLP. Sinusoidal
positions (``rope_theta = 0``), layernorm and gelu, as the reference has
them. Parameters are ``{"embed", "enc": [layer dicts], "enc_norm", "dec":
[layer dicts], "norm"}``: the reference's layer-stacked leaves become one
dictionary per layer, its `lax.scan`s Python loops.

Under ``cfg.attention_impl == "pallas"`` every encoder layer runs the
hand-written flash-attention kernel bidirectionally and every decoder layer
of `decode_train` causally (their plain version on the CPU); cross
attention is the plain chunked softmax (`layers.cross_attn_forward`), as
the reference computes it outside any Pallas kernel.

Serving: `encode` once, `prefill_cross_kv` once (each decoder layer's cross
K/V of the memory), then `decode_step` a token at a time against the
self-attention KV cache, written in place, and the fixed cross K/V.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import Policy

MEMORY_LEN = 3072          # stub frontend: frames fed to the encoder (decode)
#: keys of the parameter tree whose per-layer list the reference stacks
#: along a leading axis (its ``[L, ...]`` leaves)
STACKED_KEYS = ("enc", "dec")


def sinusoid(positions, dim: int):
    """positions: [...] -> [..., dim] standard sinusoidal encoding, in
    float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def _n_dec(cfg: ModelConfig) -> int:
    return cfg.n_dec_layers or cfg.n_layers


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig):
    d, dt, dev = cfg.d_model, cfg.pdtype(), gen.device
    return {"ln1": L.norm_init(d, dt, cfg.norm_type, dev),
            "attn": L.attn_init(gen, cfg),
            "ln2": L.norm_init(d, dt, cfg.norm_type, dev),
            "mlp": L.mlp_init(gen, cfg)}


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig):
    d, dt, dev = cfg.d_model, cfg.pdtype(), gen.device
    return {"ln1": L.norm_init(d, dt, cfg.norm_type, dev),
            "attn": L.attn_init(gen, cfg),
            "lnx": L.norm_init(d, dt, cfg.norm_type, dev),
            "xattn": L.attn_init(gen, cfg),
            "ln2": L.norm_init(d, dt, cfg.norm_type, dev),
            "mlp": L.mlp_init(gen, cfg)}


def param_axes(cfg: ModelConfig, pol: Policy) -> dict:
    """The logical axes of every leaf of `init_params`' tree (the
    reference's `Boxed` axes, without the leading "layers")."""
    n = L.norm_axes(cfg.norm_type)
    enc = {"ln1": n, "attn": L.attn_axes(), "ln2": n, "mlp": L.mlp_axes(cfg)}
    dec = dict(enc, lnx=n, xattn=L.attn_axes())
    return {"embed": L.EMBED_AXES,
            "enc": [dict(enc) for _ in range(_n_enc(cfg))],
            "enc_norm": n,
            "dec": [dict(dec) for _ in range(_n_dec(cfg))],
            "norm": n}


def init_params(cfg: ModelConfig, pol: Policy, gen: torch.Generator):
    """Random parameters on `gen`'s device, drawn from `gen` in a fixed
    order (embedding, encoder layers, decoder layers)."""
    d, dt, dev = cfg.d_model, cfg.pdtype(), gen.device
    return {
        "embed": L.embed_init(gen, L.padded_vocab(cfg), d, dt),
        "enc": [_enc_layer_init(gen, cfg) for _ in range(_n_enc(cfg))],
        "enc_norm": L.norm_init(d, dt, cfg.norm_type, dev),
        "dec": [_dec_layer_init(gen, cfg) for _ in range(_n_dec(cfg))],
        "norm": L.norm_init(d, dt, cfg.norm_type, dev),
    }


def _layers(cfg: ModelConfig, pol: Policy, body, x, layer_params):
    """x through `body(x, lp)` for each layer, each under a checkpoint
    when the config remats and gradients are on; on a mesh that shards
    weights over ZeRO-3's axes, the layer's weights gathered whole first,
    inside the checkpoint (`Policy.at_use`)."""
    remat = cfg.remat != "none" and torch.is_grad_enabled()

    def layer(x, lp):
        return body(x, pol.at_use(lp))

    for lp in layer_params:
        # nothing in a layer draws random numbers: no RNG state to replay
        x = (checkpoint(layer, x, lp, use_reentrant=False,
                        preserve_rng_state=False) if remat else layer(x, lp))
    return x


def encode(cfg: ModelConfig, pol: Policy, params, frames):
    """frames: [B, S_enc, d] precomputed frontend embeddings -> memory."""
    B, S, d = frames.shape
    x = frames.to(cfg.cdtype())
    positions = torch.arange(S, device=x.device)
    x = x + sinusoid(positions, d)[None].to(x.dtype)
    positions = positions[None, :]

    def body(x, lp):
        h = L.apply_norm(lp["ln1"], x, cfg.norm_eps, cfg.norm_type)
        a, _ = L.attn_forward(lp["attn"], cfg, pol, h, positions,
                              causal=False)
        x = x + a
        h = L.apply_norm(lp["ln2"], x, cfg.norm_eps, cfg.norm_type)
        return x + L.mlp_forward(lp["mlp"], cfg, pol, h)

    x = _layers(cfg, pol, body, x, params["enc"])
    return L.apply_norm(params["enc_norm"], x, cfg.norm_eps, cfg.norm_type)


def decode_train(cfg: ModelConfig, pol: Policy, params, tokens, memory):
    """Teacher-forced decoder over the whole target sequence."""
    B, S = tokens.shape
    x = L.embed_lookup(cfg, pol, params["embed"], tokens)
    positions = torch.arange(S, device=x.device)
    x = x + sinusoid(positions, cfg.d_model)[None].to(x.dtype)
    positions = positions[None, :]

    def body(x, lp):
        h = L.apply_norm(lp["ln1"], x, cfg.norm_eps, cfg.norm_type)
        a, _ = L.attn_forward(lp["attn"], cfg, pol, h, positions)
        x = x + a
        h = L.apply_norm(lp["lnx"], x, cfg.norm_eps, cfg.norm_type)
        a, _ = L.cross_attn_forward(lp["xattn"], cfg, pol, h, memory)
        x = x + a
        h = L.apply_norm(lp["ln2"], x, cfg.norm_eps, cfg.norm_type)
        return x + L.mlp_forward(lp["mlp"], cfg, pol, h)

    x = _layers(cfg, pol, body, x, params["dec"])
    return L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)


def forward(cfg: ModelConfig, pol: Policy, params, tokens, embeds=None):
    """Train / prefill: `embeds` are the encoder's frames (the stubbed
    frontend). Returns (decoder hidden [B,S,d], aux_loss = 0)."""
    if embeds is None:
        raise ValueError("encdec needs frontend frames (embeds=...)")
    memory = encode(cfg, pol, params, embeds)
    hidden = decode_train(cfg, pol, params, tokens, memory)
    return hidden, torch.zeros((), dtype=torch.float32, device=hidden.device)


class EncDecCache(NamedTuple):
    k: torch.Tensor      # [Ld, B, T, KVr, hd] decoder self-attention cache
    v: torch.Tensor
    xk: torch.Tensor     # [Ld, B, Tm, KVr, hd] precomputed cross K/V
    xv: torch.Tensor
    pos: int             # absolute position of the next token


def init_cache(cfg: ModelConfig, pol: Policy, batch: int, max_len: int,
               dtype=torch.bfloat16, memory_len: int = MEMORY_LEN,
               device=None) -> EncDecCache:
    """Zero caches at position 0, in `dtype` (bf16 by default whatever the
    config's dtype, as the reference's). ``device=None`` means the card
    (raises without one)."""
    dev = resolve_device(device)
    kvr = cfg.n_kv_heads * pol.kv_repeat
    z = lambda T: torch.zeros((_n_dec(cfg), batch, T, kvr, cfg.hd),
                              dtype=dtype, device=dev)
    return EncDecCache(k=z(max_len), v=z(max_len), xk=z(memory_len),
                       xv=z(memory_len), pos=0)


def cache_axes(cfg: ModelConfig) -> EncDecCache:
    """The logical axes of `init_cache`'s tensors, the reference's
    (`encdec.py:148-151`)."""
    ax = ("layers", "batch", "cache_seq", "kv_heads", None)
    xax = ("layers", "batch", None, "kv_heads", None)
    return EncDecCache(k=ax, v=ax, xk=xax, xv=xax, pos=())


#: logical axes of one layer's cross K/V [B, Tm, KVr, hd]
CROSS_AXES = ("batch", None, "kv_heads", None)


def _cross_decode(q, xk, xv, dtype):
    """One query row [B, 1, H, hd] against the fixed memory K/V: float32
    logits scaled after the product, a float32 softmax, the weights
    rounded to x's dtype before P.V, as in the reference (plain tensors:
    a rank's rows and heads on a mesh)."""
    B, _, H, hd = q.shape
    KVr = xk.shape[2]
    qg = q.reshape(B, 1, KVr, H // KVr, hd)
    lg = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                      xk.to(dtype).float()) / math.sqrt(hd)
    w = torch.softmax(lg, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", w.to(dtype),
                        xv.to(dtype)).reshape(B, 1, H, hd)


def decode_step(cfg: ModelConfig, pol: Policy, params, cache: EncDecCache,
                tokens):
    """One decode step against the cross K/V in the cache. tokens: [B, 1].
    Returns (logits [B,1,V], cache): the self-attention caches are written
    in place and the cache returned with ``pos + 1``."""
    B = tokens.shape[0]
    hd = cfg.hd
    x = L.embed_lookup(cfg, pol, params["embed"], tokens)
    pos = torch.full((1, 1), cache.pos, device=x.device)
    x = x + sinusoid(pos, cfg.d_model).to(x.dtype)
    for i, lp in enumerate(params["dec"]):
        h = L.apply_norm(lp["ln1"], x, cfg.norm_eps, cfg.norm_type)
        a, _, _ = L.attn_decode(lp["attn"], cfg, pol, h, cache.k[i],
                                cache.v[i], cache.pos)
        x = x + a
        # cross attention against the fixed memory K/V, on a mesh on each
        # rank's rows and heads
        h = L.apply_norm(lp["lnx"], x, cfg.norm_eps, cfg.norm_type)
        q = (h @ lp["xattn"]["wq"]).reshape(B, 1, cfg.n_heads, hd)
        o = L.on_shards(functools.partial(_cross_decode, dtype=x.dtype), pol,
                        (L.DEC_Q_AXES, CROSS_AXES, CROSS_AXES), L.DEC_Q_AXES,
                        q, cache.xk[i], cache.xv[i])
        # a partial sum over "heads" on a mesh: all-reduced, as the
        # self-attention's own
        x = x + pol.constrain(o.reshape(B, 1, cfg.n_heads * hd)
                              @ lp["xattn"]["wo"], "batch", "seq", None)
        h = L.apply_norm(lp["ln2"], x, cfg.norm_eps, cfg.norm_type)
        x = x + L.mlp_forward(lp["mlp"], cfg, pol, h)
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    logits = L.unembed(cfg, pol, x, params["embed"])
    return logits, cache._replace(pos=cache.pos + 1)


def prefill_cross_kv(cfg: ModelConfig, pol: Policy, params, memory):
    """Each decoder layer's cross K/V of the encoder memory [B, Tm, d]
    (once a request), KV heads replicated per the policy: (xk, xv), each
    [Ld, B, Tm, KVr, hd] in the memory's dtype."""
    B, Tm, d = memory.shape
    ks, vs = [], []
    for lp in params["dec"]:
        k = (memory @ lp["xattn"]["wk"]).reshape(B, Tm, cfg.n_kv_heads,
                                                 cfg.hd)
        v = (memory @ lp["xattn"]["wv"]).reshape(B, Tm, cfg.n_kv_heads,
                                                 cfg.hd)
        ks.append(L._repeat_kv(k, pol.kv_repeat))
        vs.append(L._repeat_kv(v, pol.kv_repeat))
    return torch.stack(ks), torch.stack(vs)
