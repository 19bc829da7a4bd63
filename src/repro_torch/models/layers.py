"""Shared transformer building blocks, in PyTorch.

The counterpart of the reference's `repro/models/layers.py`. Parameters
are plain dictionaries of tensors with JAX's weight orientation
``[in, out]`` (``x @ w``). The reference's `Boxed` logical axes are a tree
of their own beside each init (`EMBED_AXES`, `norm_axes`, `attn_axes`,
`mlp_axes`, and each family's `param_axes`): the reference's tuples
without the leading ``"layers"`` axis of its stacked layers, since the
port keeps one dictionary a layer. Every function takes a `Policy`, whose
`constrain` lays out a DTensor on the current mesh
(`sharding.partitioning`) and is the identity on one card. The init
functions draw on
``gen.device``: with `device.meta_generator()` they build the tree's
shapes and dtypes on the ``meta`` device and draw nothing. Public layouts are the
reference's: ``[B, S, H, hd]`` for attention and ``[B, T, KV, hd]`` for one
layer's KV cache.

Full-sequence attention runs the flash-attention kernel under
``cfg.attention_impl == "pallas"`` (CUDA on the card, its plain version on
the CPU) and the plain query-chunked softmax under ``"xla"``. On a mesh
either runs on each rank's local ``[B/data, S, H/model, hd]`` shards
through `local_map` (`on_shards`, which the recurrent families' scans use
too), and so does a decode step's cache write and attention: on its rows
and KV heads, or on its range of the cache's slots under ``seq_kv``,
combined across ranks as flash-decoding does (`attn_decode`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partitioning
from repro_torch.sharding.policy import Policy

ATTN_CHUNK = 512          # query-chunk length for full-sequence attention
NEG_INF = -1e30


def dense_init(gen: torch.Generator, in_dim, out_dim, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab, dim, dtype):
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=gen.device) * 0.02
    return w.to(dtype)


#: logical axes of the embedding table [Vp, d]
EMBED_AXES = ("vocab", "embed")


def embed_lookup(cfg: ModelConfig, pol: Policy, table, tokens):
    """The table's rows of `tokens` in the compute dtype, laid out as
    ("batch", "seq", None). On a mesh a table sharded over the vocabulary
    gives each rank the rows it holds (`F.embedding`, zeros for the rest)
    and the constraint sums them: one all-reduce of the activations, where
    indexing would gather the whole table inside DTensor's dispatch."""
    x = F.embedding(tokens, table).to(cfg.cdtype())
    # the backward of a vocabulary-sharded lookup takes a whole gradient
    return partitioning.grad_placed(pol.constrain(x, "batch", "seq", None))


def norm_axes(norm_type="rmsnorm") -> dict:
    return ({"scale": ("embed",), "bias": ("embed",)}
            if norm_type == "layernorm" else {"scale": ("embed",)})


def norm_init(dim, dtype, norm_type="rmsnorm", device=None):
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, eps, norm_type="rmsnorm"):
    xf = x.float()
    if norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]. Rotates the
    two halves of the head dim in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].float() * freqs              # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def attn_init(gen: torch.Generator, cfg: ModelConfig):
    hd, d, dt = cfg.hd, cfg.d_model, cfg.pdtype()
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dt),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dt),
    }


def attn_axes() -> dict:
    return {"wq": ("embed_fsdp", "heads"), "wk": ("embed_fsdp", "kv_heads"),
            "wv": ("embed_fsdp", "kv_heads"), "wo": ("heads", "embed_fsdp")}


def _repeat_kv(k, repeat: int):
    """Exact GQA KV replication: kv head j -> repeat copies, so that query
    head i (group g = H/KV') still reads its own key/value."""
    if repeat == 1:
        return k
    return torch.repeat_interleave(k, repeat, dim=2)


def _chunked_sdpa(q, k, v, *, causal: bool, window: int, offset: int,
                  softcap: float = 0.0, chunk: int = ATTN_CHUNK):
    """Exact softmax attention computed in query chunks (the plain path).

    q: [B, S, H, hd]; k, v: [B, T, KV, hd] with H % KV == 0. Each chunk
    computes [B, KV, g, chunk, T] float32 logits, softmaxes over T exactly,
    rounds the weights to v's dtype and contracts. ``offset`` is the
    absolute position of q[0] minus that of k[0].
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, S)
    ki = torch.arange(T, device=q.device)
    kf = k.float()
    outs = []
    for c0 in range(0, S, chunk):
        qi = q[:, c0:c0 + chunk]
        n = qi.shape[1]
        qg = qi.reshape(B, n, KV, g, hd)
        logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), kf) * scale
        if softcap > 0:
            logits = torch.tanh(logits / softcap) * softcap
        pos_q = c0 + torch.arange(n, device=q.device) + offset
        mask = torch.ones((n, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= ki[None, :] <= pos_q[:, None]
        if window > 0:
            mask &= ki[None, :] > pos_q[:, None] - window
        logits = logits.masked_fill(~mask, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
                    .reshape(B, n, H, hd))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


#: logical axes of the attention's queries and of its keys and values
Q_AXES = ("attn_batch", "seq", "heads", None)
KV_AXES = ("attn_batch", "kv_seq", "kv_heads", None)


class Summed(NamedTuple):
    """Out axes of an `on_shards` result that each rank holds as a partial
    `op` ("sum" or "max") over the ranks of the mesh axis `over`: laid out
    on `axes` otherwise. The `constrain` that follows reduces it."""
    axes: tuple
    over: str = "model"
    op: str = "sum"


def on_shards(fn, pol: Policy, in_axes, out_axes, *args):
    """`fn(*args)`; for DTensors, on each rank's local shards through
    `local_map`. Each tensor argument is first laid out on its logical
    axes in `in_axes` (`constrain`: a gather or a reduction where its
    placements differ, once, before `fn`); None stands for an argument
    that is not a tensor (or is None). `fn` then runs on plain local
    tensors and its outputs are placed on `out_axes`: one logical-axes
    tuple (or `Summed`) for a single output, a list of them for a tuple
    of outputs. `fn` must compute each local output from the local inputs
    alone (rows, heads or channels that do not interact across ranks),
    or a partial result that a `Summed` output declares.

    In the backward each local input's gradient is placed as its input
    is, except on a mesh axis where the input is replicated and some
    output is not: there the ranks computed different parts from it, and
    its gradient is their partial sum (a weight beside rows sharded over
    the batch's axes, or hidden states beside a vocabulary slice)."""
    lead = next((a for a in args if partitioning.is_dtensor(a)), None)
    if lead is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = partitioning.current_mesh() or lead.device_mesh

    def place(ax):
        if not isinstance(ax, Summed):
            return list(partitioning.logical_placements(mesh, ax, pol.rules))
        out = list(partitioning.logical_placements(mesh, ax.axes, pol.rules))
        out[list(mesh.mesh_dim_names).index(ax.over)] = Partial(ax.op)
        return out

    args = [a if ax is None or a is None else pol.constrain(a, *ax)
            for a, ax in zip(args, in_axes)]
    ins = tuple(None if ax is None or a is None else place(ax)
                for a, ax in zip(args, in_axes))
    # a list of placements is one output's; a tuple holds one an output
    outs = (tuple(place(ax) for ax in out_axes)
            if isinstance(out_axes, list) else place(out_axes))
    split = [any(not o[i].is_replicate() for o in
                 (outs if isinstance(out_axes, list) else (outs,)))
             for i in range(mesh.ndim)]
    grads = tuple(None if pl is None else
                  [Partial() if p.is_replicate() and split[i] else p
                   for i, p in enumerate(pl)] for pl in ins)
    with partitioning.local_ops_unrecorded():
        return local_map(fn, out_placements=outs, in_placements=ins,
                         in_grad_placements=grads, device_mesh=mesh)(*args)


def _attention_on_shards(fn, pol: Policy, q, k, v, **kw):
    """`fn(q, k, v, **kw)`; for DTensors, on each rank's local shards
    (`on_shards`), with the placements of `Q_AXES` / `KV_AXES` in and
    `Q_AXES` out, so that the kernel sees its rank's ``[B/data, S,
    H/model, hd]`` tensors. Heads and batch rows are independent, so the
    local results are the global one's shards. A sharded sequence needs
    the keys of other ranks: it raises (``dp_seq``, with its K/V gather
    and dK/dV reduce-scatter, waits for ROADMAP.md item 19b, step 3b)."""
    if partitioning.is_dtensor(q) and pol.rules.get("seq") is not None:
        raise NotImplementedError("attention over a sequence sharded on a "
                                  "mesh (dp_seq) is not ported (ROADMAP.md "
                                  "item 19b, step 3b)")
    return on_shards(functools.partial(fn, **kw), pol,
                     (Q_AXES, KV_AXES, KV_AXES), Q_AXES, q, k, v)


def attn_forward(p, cfg: ModelConfig, pol: Policy, x, positions,
                 window: int = 0, causal: bool = True):
    """Full-sequence (train / prefill) attention. Returns (out, (k, v)).

    The returned k, v have KV heads already replicated per the policy, ready
    to seed a decode cache. The reference's constraint points are kept
    (`layers.py:210-226`), and one more on the output projection: on a
    mesh, with heads over "model", that product is a partial sum, and the
    constraint makes its all-reduce explicit where the reference leaves it
    to XLA.
    """
    B, S, d = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k = _repeat_kv(k, pol.kv_repeat)
    v = _repeat_kv(v, pol.kv_repeat)
    q = pol.constrain(q, *Q_AXES)
    k = pol.constrain(k, *KV_AXES)
    v = pol.constrain(v, *KV_AXES)
    if cfg.attention_impl == "pallas":
        out = _attention_on_shards(flash_attention, pol, q, k, v,
                                   causal=causal, window=window,
                                   softcap=cfg.logit_softcap)
    else:
        # a sequence sharded by the policy (dp_seq) takes the reference's
        # unchunked branch, though one card shards nothing
        seq_sharded = pol.rules.get("seq") is not None
        out = _attention_on_shards(
            _chunked_sdpa, pol, q, k, v, causal=causal, window=window,
            offset=0, softcap=cfg.logit_softcap,
            chunk=S if seq_sharded else ATTN_CHUNK)
    out = pol.constrain(out, *Q_AXES)
    y = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
    return pol.constrain(y, "batch", "seq", None), (k, v)


def cross_attn_forward(p, cfg: ModelConfig, pol: Policy, x, memory):
    """Encoder-decoder cross attention (no mask, no rope): x [B, S, d]
    attends to memory [B, Tm, d] through the plain chunked softmax, as the
    reference computes it outside any Pallas kernel; on a mesh, on each
    rank's heads (`_attention_on_shards`). Returns (out, (k, v))."""
    B, S, d = x.shape
    hd = cfg.hd
    Tm = memory.shape[1]
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (memory @ p["wk"]).reshape(B, Tm, cfg.n_kv_heads, hd)
    v = (memory @ p["wv"]).reshape(B, Tm, cfg.n_kv_heads, hd)
    k = _repeat_kv(k, pol.kv_repeat)
    v = _repeat_kv(v, pol.kv_repeat)
    out = _attention_on_shards(_chunked_sdpa, pol, q, k, v, causal=False,
                               window=0, offset=0)
    y = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
    # a partial sum over "heads" on a mesh: all-reduced, as in attn_forward
    return pol.constrain(y, "batch", "seq", None), (k, v)


#: logical axes of one decode step's query [B, 1, H, hd], new key and
#: value [B, 1, KVr, hd] and one layer's cache [B, T, KVr, hd] (the
#: reference's `constrain` of the cache, `layers.py:285-286`)
DEC_Q_AXES = ("batch", "seq", "heads", None)
DEC_KV_AXES = ("batch", "seq", "kv_heads", None)
CACHE_AXES = ("batch", "cache_seq", "kv_heads", None)


def attn_decode(p, cfg: ModelConfig, pol: Policy, x, cache_k, cache_v, pos,
                window: int = 0):
    """One-token decode step.

    x: [B, 1, d]; cache_[kv]: [B, T, KVr, hd] (KV heads pre-replicated);
    pos: int, [] or [B] absolute position of the new token. With a ring
    cache (window > 0 and T == window) the write index is pos % T.
    The new key and value are written into `cache_k` / `cache_v` IN PLACE
    (the reference returns updated copies). Returns
    (out [B, 1, d], cache_k, cache_v).

    On a mesh (an int `pos`) the write and the attention run on each
    rank's local shards (`on_shards`): under ``tp_heads`` its batch rows
    and KV heads, the output projection's partial sum all-reduced, as
    `attn_forward`'s; under ``seq_kv`` (the cache's time axis sharded,
    ``rules["cache_seq"]``) its range of slots, combined across ranks as
    flash-decoding does (`_attend_seq_kv`).
    """
    B, _, d = x.shape
    hd = cfg.hd
    T = cache_k.shape[1]
    ring = window > 0 and T == window
    if isinstance(pos, int) and not ring and pos >= T:
        raise ValueError(f"position {pos} does not fit a cache of {T} slots")
    mesh = partitioning.is_dtensor(x)
    if mesh and isinstance(pos, torch.Tensor):
        raise NotImplementedError("decode on a mesh takes one int position "
                                  "for every row")
    q = (x @ p["wq"]).reshape(B, 1, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.rope_theta > 0:
        # every row at one position: [1, 1], broadcast over the rows
        at = (pos.to(x.device).expand(B)[:, None]
              if isinstance(pos, torch.Tensor)
              else torch.full((1, 1), int(pos), device=x.device))
        q = apply_rope(q, at, cfg.rope_theta)
        k = apply_rope(k, at, cfg.rope_theta)
    k = _repeat_kv(k, pol.kv_repeat)
    v = _repeat_kv(v, pol.kv_repeat)
    kw = dict(pos=pos, T=T, ring=ring, window=window,
              softcap=cfg.logit_softcap, dtype=x.dtype)
    if mesh and pol.rules.get("cache_seq") is not None:
        out = _attend_seq_kv(pol, q, k, v, cache_k, cache_v, **kw)
    else:
        out = on_shards(functools.partial(_write_and_attend, **kw), pol,
                        (DEC_Q_AXES, DEC_KV_AXES, DEC_KV_AXES, CACHE_AXES,
                         CACHE_AXES), DEC_Q_AXES, q, k, v, cache_k, cache_v)
    y = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"]
    # a partial sum over "heads" on a mesh: all-reduced, as in attn_forward
    return pol.constrain(y, "batch", "seq", None), cache_k, cache_v


def _positions(pos, B: int, device):
    if isinstance(pos, torch.Tensor):
        return pos.to(device).expand(B)
    # a fill on the device: no host-to-device copy, no sync
    return torch.full((B,), int(pos), dtype=torch.long, device=device)


def _valid_slots(ki, slot, posb, T: int, ring: bool, window: int):
    """Which of the absolute slots `ki` [1, n] a query at `posb` [B] sees."""
    if ring:
        # slot i holds absolute position: valid iff within the last `window`
        age = (slot[:, None] - ki) % T
        return age <= torch.clamp(posb[:, None], max=T - 1)
    valid = ki <= posb[:, None]
    if window > 0:
        valid &= ki > posb[:, None] - window
    return valid


def _decode_logits(q, cache_k, valid, softcap: float, dtype):
    """Float32 logits [B, KVr, g, 1, n] of the query against the slots of
    `cache_k` [B, n, KVr, hd], the invalid ones -1e30."""
    B, _, H, hd = q.shape
    KVr = cache_k.shape[2]
    qg = q.reshape(B, 1, KVr, H // KVr, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          cache_k.to(dtype).float()) / math.sqrt(hd)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)


def _write_and_attend(q, k, v, cache_k, cache_v, *, pos, T, ring, window,
                      softcap, dtype):
    """The new row written at its slot, then the query's attention over
    every slot of the cache (plain tensors: a rank's rows and heads on a
    mesh). Returns out [B, 1, H, hd]."""
    B, _, H, hd = q.shape
    posb = _positions(pos, B, q.device)
    slot = posb % T if ring else posb
    # The reference blends a one-hot row into the cache; writing the new
    # row at `slot` gives the same values (the blend multiplies the other
    # rows by exactly 1 and the slot's old value by exactly 0).
    rows = torch.arange(B, device=q.device)
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    ki = torch.arange(T, device=q.device)[None, :]
    logits = _decode_logits(q, cache_k, _valid_slots(ki, slot, posb, T, ring,
                                                     window), softcap, dtype)
    w = torch.softmax(logits, dim=-1)
    # the weights are rounded to x's dtype before P.V, as in the reference
    return torch.einsum("bkgst,btkh->bskgh", w.to(dtype),
                        cache_v.to(dtype)).reshape(B, 1, H, hd)


def _slot_range(T: int, mesh_axis: str):
    """(first absolute slot, count) of this rank's shard of a time axis of
    T slots split over `mesh_axis` (DTensor's even split, the last shards
    the shorter)."""
    mesh = partitioning.current_mesh()
    n, r = mesh.size(mesh.mesh_dim_names.index(mesh_axis)), \
        mesh.get_local_rank(mesh_axis)
    size = -(-T // n)
    return min(r * size, T), max(0, min(size, T - r * size))


def _attend_seq_kv(pol: Policy, q, k, v, cache_k, cache_v, *, pos, T, ring,
                   window, softcap, dtype):
    """`seq_kv` decode attention, flash-decoding: each rank holds T / n
    slots of every head (the cache's time axis on "model") and writes the
    new row only where its slots hold `slot`; it computes the float32
    logits over its slots, masked by their absolute indices; the ranks
    combine their maxima (an all-reduce of max), then their sums of
    exp(logit - max) (of sum), and each rank's weights, rounded to x's
    dtype before P.V as the reference rounds them, give its partial P.V,
    summed in float32 (of sum). A rank whose slots are all masked adds
    zero. Returns out [B, 1, H, hd], replicated over "model"."""
    axis = pol.rules["cache_seq"]
    if not isinstance(axis, str):
        raise NotImplementedError(f"cache_seq over {axis!r}")
    off, n = _slot_range(T, axis)
    stats = ("batch", "kv_heads", None, None, None)

    def logits_of(q, k, v, cache_k, cache_v):
        B = q.shape[0]
        posb = _positions(pos, B, q.device)
        slot = pos % T if ring else pos
        if off <= slot < off + n:
            cache_k[:, slot - off] = k[:, 0].to(cache_k.dtype)
            cache_v[:, slot - off] = v[:, 0].to(cache_v.dtype)
        ki = off + torch.arange(n, device=q.device)[None, :]
        logits = _decode_logits(
            q, cache_k, _valid_slots(ki, posb % T if ring else posb, posb, T,
                                     ring, window), softcap, dtype)
        return logits, logits.amax(-1, keepdim=True)

    logits, m = on_shards(
        logits_of, pol, (DEC_Q_AXES, DEC_KV_AXES, DEC_KV_AXES, CACHE_AXES,
                         CACHE_AXES),
        [("batch", "kv_heads", None, None, "cache_seq"),
         Summed(stats, axis, "max")], q, k, v, cache_k, cache_v)
    m = pol.constrain(m, *stats)
    e, l = on_shards(lambda lg, m: (lambda e: (e, e.sum(-1, keepdim=True)))(
        torch.exp(lg - m)), pol,
        (("batch", "kv_heads", None, None, "cache_seq"), stats),
        [("batch", "kv_heads", None, None, "cache_seq"), Summed(stats, axis)],
        logits, m)
    l = pol.constrain(l, *stats)

    def pv(e, l, cache_v):
        B, KVr, g = e.shape[:3]
        w = (e / l).to(dtype)
        return torch.einsum("bkgst,btkh->bskgh", w, cache_v.to(dtype)
                            ).reshape(B, 1, KVr * g, -1).float()

    out = on_shards(pv, pol, (("batch", "kv_heads", None, None, "cache_seq"),
                              stats, CACHE_AXES),
                    Summed(DEC_Q_AXES, axis), e, l, cache_v)
    return pol.constrain(out, *DEC_Q_AXES).to(dtype)


# ---------------------------------------------------------------- conv

def causal_conv(x, kernel, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of the recurrent blocks (RG-LRU, mLSTM).
    x: [B, S, C]; kernel: [W, C]; state: [B, W-1, C] trailing inputs of the
    previous call (decode). The W taps are summed left to right in x's
    dtype, as the reference's Python `sum` rounds them. Returns
    (out [B, S, C], the new state)."""
    W = kernel.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * kernel[i] for i in range(W))
    return out, xp[:, -(W - 1):]


# ---------------------------------------------------------------- MLP

def mlp_axes(cfg: ModelConfig) -> dict:
    p = {"wi": ("embed_fsdp", "mlp"), "wo": ("mlp", "embed_fsdp")}
    if cfg.mlp_type == "swiglu":
        p["wg"] = ("embed_fsdp", "mlp")
    return p


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff=None,
             d_model=None):
    """The MLP at widths `d_model` -> `d_ff` -> `d_model` (the config's by
    default; the MoE layer's parallel branch passes its own `d_ff`)."""
    d, dt = d_model or cfg.d_model, cfg.pdtype()
    d_ff = d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wi": dense_init(gen, d, d_ff, dt),
                "wg": dense_init(gen, d, d_ff, dt),
                "wo": dense_init(gen, d_ff, d, dt)}
    return {"wi": dense_init(gen, d, d_ff, dt),
            "wo": dense_init(gen, d_ff, d, dt)}


def mlp_forward(p, cfg: ModelConfig, pol: Policy, x):
    """The reference's constraint on the hidden units (`layers.py:327`),
    and one on the down projection, a partial sum over "model" on a mesh
    (see `attn_forward`)."""
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")   # jax.nn.gelu's default
    h = pol.constrain(h, "batch", "seq", "mlp")
    return pol.constrain(h @ p["wo"], "batch", "seq", None)


# ---------------------------------------------------------------- head

def unembed(cfg: ModelConfig, pol: Policy, x, embed_w):
    """Project to (padded) vocab logits with the embedding table; padded
    entries masked to -1e30."""
    logits = x @ embed_w.to(x.dtype).T
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    pad = logits.shape[-1] - cfg.vocab_size
    if pad > 0:
        mask = torch.arange(logits.shape[-1], device=x.device) < cfg.vocab_size
        logits = logits.masked_fill(~mask, NEG_INF)
    return pol.constrain(logits, "batch", "seq", "vocab")


def padded_vocab(cfg: ModelConfig, multiple: int = 16) -> int:
    return int(math.ceil(cfg.vocab_size / multiple) * multiple)
