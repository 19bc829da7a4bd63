"""RecurrentGemma-style hybrid LM: RG-LRU recurrent blocks + local attention,
in PyTorch.

The counterpart of the reference's `repro/models/hybrid.py` (Griffin,
arXiv:2402.19427): residual blocks cycle through ``cfg.block_pattern``
(("rec", "rec", "attn") for recurrentgemma-2b), each block temporal mixing
+ gated MLP, pre-norm. The RG-LRU is the diagonal linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t = sigmoid gates,

run over the whole sequence by the hand-written CUDA kernel under
``cfg.attention_impl == "pallas"`` (`kernels/rglru_scan`, its plain version
on the CPU; differentiable through its reverse walk) and by a plain
log-depth associative scan (`lru_scan`, autograd's own gradient) under
``"xla"``. Local attention runs the flash-attention kernel or the chunked
softmax, as in `layers.attn_forward`.

Parameters are ``{"embed", "reps": [R superblock dicts], "tail", "norm"}``:
the reference's pattern-repeat-stacked leaves ``[R, ...]`` become one
dictionary per repeat and its `lax.scan` over repeats a Python loop; the
non-multiple tail (26 = 8 * 3 + 2) stays unrolled. The reference's
``kind_*`` structural markers are not carried. With ``cfg.remat != "none"``
each repeat runs under `torch.utils.checkpoint` (non-reentrant), as the
reference wraps its scan body in `jax.checkpoint`; the tail does not.

Serving: `init_cache` holds the RG-LRU states, the conv tails and ring
KV caches of ``local_window`` slots; `decode_step` runs one token through
every layer, a recurrent block as one RG-LRU step (``rglru_forward`` with
``state``: S = 1 takes `lru_scan`, never the kernel, as in the reference)
and an attention block as `layers.attn_decode` on its ring, writing the
state in place. `serve.engine.generate` replays a prompt through it token
by token, as the reference does.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.rglru_scan.ops import chunked_lru
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import Policy

LRU_C = 8.0
#: logical axes of the recurrence's operands [B, S, dr] and state [B, dr]
RNN_AXES = ("batch", "seq", "rnn")
H_AXES = ("batch", "rnn")
CONV_AXES = ("batch", None, "rnn")         # the conv tail [B, W-1, dr]
#: keys of the parameter tree whose per-repeat list the reference stacks
#: along a leading axis (its ``[R, ...]`` leaves)
STACKED_KEYS = ("reps",)


def _pattern(cfg: ModelConfig) -> tuple[str, ...]:
    return cfg.block_pattern or ("rec", "rec", "attn")


def _split(cfg: ModelConfig):
    pat = _pattern(cfg)
    reps, tail = divmod(cfg.n_layers, len(pat))
    return pat, reps, pat[:tail]


# ------------------------------------------------------------------ RG-LRU

def rglru_init(gen: torch.Generator, cfg: ModelConfig):
    d, dr, dt = cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.pdtype()
    dev = gen.device
    # Lambda init so a^c in [0.9, 0.999] (Griffin appendix)
    u = torch.rand((dr,), generator=gen, device=dev) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / LRU_C))    # softplus^-1
    return {
        "ln": L.norm_init(d, dt, cfg.norm_type, dev),
        "wx": L.dense_init(gen, d, dr, dt),
        "wy": L.dense_init(gen, d, dr, dt),
        "conv": torch.randn((cfg.conv_width, dr), generator=gen,
                            device=dev).to(dt) * 0.1,
        "wr": L.dense_init(gen, dr, dr, torch.float32, scale=0.02),
        "wi": L.dense_init(gen, dr, dr, torch.float32, scale=0.02),
        "lam": lam,
        "wo": L.dense_init(gen, dr, d, dt),
    }


def rglru_axes(cfg: ModelConfig) -> dict:
    return {"ln": L.norm_axes(cfg.norm_type), "wx": ("embed_fsdp", "rnn"),
            "wy": ("embed_fsdp", "rnn"), "conv": (None, "rnn"),
            "wr": ("rnn", None), "wi": ("rnn", None), "lam": ("rnn",),
            "wo": ("rnn", "embed_fsdp")}


def rglru_gates(p, u, pol: Policy | None = None):
    """u: [B, S, dr] conv output -> (a, bx) of h = a*h + bx, float32. On
    a mesh (`pol` given) the gates' products over the sharded "rnn" are
    partial sums, reduced and scattered back onto "rnn", so that every
    operand of the recurrence keeps its rank's channels."""
    uf = u.float()
    keep = (lambda x: x) if pol is None else (
        lambda x: pol.constrain(x, *RNN_AXES))
    r = torch.sigmoid(keep(uf @ p["wr"]))
    i = torch.sigmoid(keep(uf @ p["wi"]))
    log_a = -LRU_C * F.softplus(p["lam"]) * r       # [B, S, dr]
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return a, bx


def _shift(x, s: int, fill: float):
    """x shifted s steps later along axis 1, the first s steps `fill`."""
    pad = torch.full_like(x[:, :s], fill)
    return torch.cat([pad, x[:, :-s]], dim=1)


def lru_scan(a, bx, h0=None):
    """Diagonal first-order recurrence by a log-depth associative scan over
    time (the reference's ``"xla"`` path), in plain differentiable ops:
    after the round of shift s every position holds the composition of the
    2s steps that end there."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    S = a.shape[1]
    s = 1
    while s < S:
        # (a1, b1) the earlier span, (a2, b2) the later: (a1 a2, a2 b1 + b2)
        bx = a * _shift(bx, s, 0.0) + bx
        a = _shift(a, s, 1.0) * a
        s *= 2
    return bx


def rglru_forward(p, cfg: ModelConfig, pol: Policy, x, state=None,
                  return_state: bool = False):
    """Griffin recurrent block body. state = (h [B,dr], conv [B,W-1,dr])."""
    B, S, d = x.shape
    h = L.apply_norm(p["ln"], x, cfg.norm_eps, cfg.norm_type)
    u = h @ p["wx"]
    gate = F.gelu(h @ p["wy"], approximate="tanh")  # jax.nn.gelu's default
    u = pol.constrain(u, "batch", "seq", "rnn")
    h0, conv_st = state if state is not None else (None, None)
    # a depthwise conv along time: each rank's channels on a mesh
    u, conv_st = L.on_shards(L.causal_conv, pol, (RNN_AXES, (None, "rnn"),
                                                  CONV_AXES),
                             [RNN_AXES, CONV_AXES], u, p["conv"], conv_st)
    a, bx = rglru_gates(p, u, pol)
    # on a mesh, each rank's kernel (or scan) walks its [B/data, S,
    # dr/model] shard: channels and rows are independent
    scan = chunked_lru if cfg.attention_impl == "pallas" and S > 1 \
        else lru_scan
    hs = L.on_shards(scan, pol, (RNN_AXES, RNN_AXES, H_AXES), RNN_AXES, a,
                     bx, h0)
    # on a mesh the product over the sharded "rnn" is a partial sum: the
    # constraint all-reduces it, as `layers.attn_forward` does its own
    y = pol.constrain((hs.to(x.dtype) * gate) @ p["wo"], "batch", "seq", None)
    if return_state:
        return y, (hs[:, -1], conv_st)
    return y


# ------------------------------------------------------------------ blocks

def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str):
    dev = gen.device
    p = {"ln2": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type, dev),
         "mlp": L.mlp_init(gen, cfg)}
    if kind == "rec":
        p["rec"] = rglru_init(gen, cfg)
    else:
        p["ln1"] = L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type, dev)
        p["attn"] = L.attn_init(gen, cfg)
    return p


def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    p = {"ln2": L.norm_axes(cfg.norm_type), "mlp": L.mlp_axes(cfg)}
    if kind == "rec":
        p["rec"] = rglru_axes(cfg)
    else:
        p["ln1"] = L.norm_axes(cfg.norm_type)
        p["attn"] = L.attn_axes()
    return p


def _block_fwd(p, cfg: ModelConfig, pol: Policy, x, positions, kind: str):
    if kind == "rec":
        x = x + rglru_forward(p["rec"], cfg, pol, x)
    else:
        h = L.apply_norm(p["ln1"], x, cfg.norm_eps, cfg.norm_type)
        a, _ = L.attn_forward(p["attn"], cfg, pol, h, positions,
                              window=cfg.local_window)
        x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm_eps, cfg.norm_type)
    x = x + L.mlp_forward(p["mlp"], cfg, pol, h)
    return pol.constrain(x, "batch", "seq", None)


def init_params(cfg: ModelConfig, pol: Policy, gen: torch.Generator):
    """Random parameters on `gen`'s device, drawn from `gen` in a fixed
    order (embedding, the repeats block by block, the tail)."""
    pat, reps, tail = _split(cfg)

    def superblock():
        return {f"b{i}_{t}": _block_init(gen, cfg, t)
                for i, t in enumerate(pat)}

    params = {
        "embed": L.embed_init(gen, L.padded_vocab(cfg), cfg.d_model,
                              cfg.pdtype()),
        "reps": [superblock() for _ in range(reps)],
        "norm": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type,
                            gen.device),
    }
    if tail:
        params["tail"] = {f"t{i}_{t}": _block_init(gen, cfg, t)
                          for i, t in enumerate(tail)}
    return params


def param_axes(cfg: ModelConfig, pol: Policy) -> dict:
    """The logical axes of every leaf of `init_params`' tree (the
    reference's `Boxed` axes, without the leading "layers" of the
    repeats; the structural ``kind_*`` markers are not parameters)."""
    pat, reps, tail = _split(cfg)
    axes = {"embed": L.EMBED_AXES,
            "reps": [{f"b{i}_{t}": _block_axes(cfg, t)
                      for i, t in enumerate(pat)} for _ in range(reps)],
            "norm": L.norm_axes(cfg.norm_type)}
    if tail:
        axes["tail"] = {f"t{i}_{t}": _block_axes(cfg, t)
                        for i, t in enumerate(tail)}
    return axes


def forward(cfg: ModelConfig, pol: Policy, params, tokens, embeds=None):
    """Full-sequence forward (the training step's). Returns (hidden [B,S,d]
    post-final-norm, aux_loss = 0). `embeds` is not read, as in the
    reference: the family has no frontend input."""
    pat, reps, tail = _split(cfg)
    B, S = tokens.shape
    x = L.embed_lookup(cfg, pol, params["embed"], tokens)
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, bp):
        for i, t in enumerate(pat):
            x = _block_fwd(bp[f"b{i}_{t}"], cfg, pol, x, positions, t)
        return x

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for bp in params["reps"]:
        # nothing in a block draws random numbers: no RNG state to replay
        x = (checkpoint(body, x, bp, use_reentrant=False,
                        preserve_rng_state=False) if remat else body(x, bp))
    for i, t in enumerate(tail):
        x = _block_fwd(params["tail"][f"t{i}_{t}"], cfg, pol, x, positions, t)
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ------------------------------------------------------------------ decode

@dataclasses.dataclass(frozen=True)
class HybridCache:
    """Decode state: O(window + d_rnn) whatever the position."""
    h: torch.Tensor       # [n_rec, B, dr] RG-LRU states, float32
    conv: torch.Tensor    # [n_rec, B, W-1, dr] conv tails, float32
    k: torch.Tensor       # [n_attn, B, T, KVr, hd] (ring) KV caches
    v: torch.Tensor
    pos: int              # absolute position of the next token


def _counts(cfg: ModelConfig):
    pat, reps, tail = _split(cfg)
    seq = list(pat) * reps + list(tail)
    return seq, seq.count("rec"), seq.count("attn")


def init_cache(cfg: ModelConfig, pol: Policy, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> HybridCache:
    """Zero state at position 0. The KV caches hold ``T = min(max_len,
    local_window)`` slots, a ring when ``T == local_window``, in `dtype`
    (bf16 by default whatever the config's dtype, as the reference's).
    ``device=None`` means the card (raises without one)."""
    dev = resolve_device(device)
    _, n_rec, n_attn = _counts(cfg)
    dr = cfg.d_rnn or cfg.d_model
    W = cfg.conv_width
    T = min(max_len, cfg.local_window) if cfg.local_window else max_len
    kvr = cfg.n_kv_heads * pol.kv_repeat
    kv = (n_attn, batch, T, kvr, cfg.hd)
    return HybridCache(
        h=torch.zeros((n_rec, batch, dr), dtype=torch.float32, device=dev),
        conv=torch.zeros((n_rec, batch, W - 1, dr), dtype=torch.float32,
                         device=dev),
        k=torch.zeros(kv, dtype=dtype, device=dev),
        v=torch.zeros(kv, dtype=dtype, device=dev),
        pos=0)


def cache_axes(cfg: ModelConfig) -> HybridCache:
    """The logical axes of `init_cache`'s tensors, the reference's
    (`hybrid.py:227-233`)."""
    kv = ("layers", "batch", "cache_seq", "kv_heads", None)
    return HybridCache(h=("layers",) + H_AXES, conv=("layers",) + CONV_AXES,
                       k=kv, v=kv, pos=())


def _layers(cfg: ModelConfig, params):
    """(block parameters, kind) of every layer, in order."""
    pat, reps, tail = _split(cfg)
    for bp in params["reps"]:
        for i, t in enumerate(pat):
            yield bp[f"b{i}_{t}"], t
    for i, t in enumerate(tail):
        yield params["tail"][f"t{i}_{t}"], t


def decode_step(cfg: ModelConfig, pol: Policy, params, cache: HybridCache,
                tokens):
    """One-token decode. tokens: [B, 1]. Returns (logits [B,1,V], cache):
    the cache's tensors are updated in place (the reference restacks new
    ones) and returned with ``pos + 1``. A conv tail is kept in float32,
    which holds a bf16 tail exactly. On a mesh each new state is laid out
    on its cache slice's axes before the copy."""
    x = L.embed_lookup(cfg, pol, params["embed"], tokens)
    ri = ai = 0
    for p, t in _layers(cfg, params):
        if t == "rec":
            y, (h1, c1) = rglru_forward(p["rec"], cfg, pol, x,
                                        state=(cache.h[ri], cache.conv[ri]),
                                        return_state=True)
            cache.h[ri].copy_(pol.constrain(h1, *H_AXES))
            cache.conv[ri].copy_(pol.constrain(c1, *CONV_AXES))
            ri += 1
            x = x + y
        else:
            h = L.apply_norm(p["ln1"], x, cfg.norm_eps, cfg.norm_type)
            a, _, _ = L.attn_decode(p["attn"], cfg, pol, h, cache.k[ai],
                                    cache.v[ai], cache.pos,
                                    window=cfg.local_window)
            ai += 1
            x = x + a
        hh = L.apply_norm(p["ln2"], x, cfg.norm_eps, cfg.norm_type)
        x = x + L.mlp_forward(p["mlp"], cfg, pol, hh)
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    logits = L.unembed(cfg, pol, x, params["embed"])
    return logits, dataclasses.replace(cache, pos=cache.pos + 1)
