"""xLSTM language model (mLSTM + sLSTM blocks), attention-free, in PyTorch.

The counterpart of the reference's `repro/models/xlstm.py` (arXiv:2405.04517):
a stack of pre-norm residual blocks following ``cfg.xlstm_pattern``
(xlstm-1.3b: 7 mLSTM : 1 sLSTM, repeated 6 times). Parameters are
``{"embed", "blocks": [R superblock dicts], "norm"}``: the reference's
pattern-repeat-stacked leaves ``[R, ...]`` become one dictionary per repeat,
keyed ``b{i}_{t}``, and its `lax.scan` over repeats a Python loop. With
``cfg.remat != "none"`` each repeat runs under `torch.utils.checkpoint`, as
the reference wraps its scan body in `jax.checkpoint`.

mLSTM: the matrix memory C_t = f_t C_{t-1} + i_t v_t k_t^T with per-head
sigmoid gates, in the reference's chunkwise-parallel form: inside a chunk
an attention-like product with the decay matrix A_ts = i_s exp(F_t - F_s)
(F = cumsum log f); between chunks a Python loop carries (C, n), where the
reference has a `lax.scan`. Every expression is the reference's, its double
scaling of k included (`k / sqrt(dh)`, then ``scale`` again in the scan).

sLSTM: the scalar memory with exponential gating, stabilised by a running
max (m_0 = -1e9), and a block-diagonal recurrence, a time loop in float32.

Neither has a Pallas kernel in the reference: both are plain `jnp` there
and plain PyTorch here. Serving: `init_cache` holds the float32 states
(O(1) in the context length) and `decode_step` runs one token through every
block, writing the new state into the cache in place (the reference
restacks new arrays); `serve.engine.generate` replays a prompt through it
token by token. On a mesh a decode step keeps each mLSTM block's matrix
memory C on the ranks of its dv columns (`cache_axes`,
`_mlstm_decode_sharded`): only one token's vectors cross ranks.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import meta_repeat, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partitioning
from repro_torch.sharding.policy import Policy

PROJ_FACTOR = 2          # mLSTM up-projection factor
SLSTM_FF = 4 / 3         # sLSTM post-MLP factor (GeGLU)
#: keys of the parameter tree whose per-repeat list the reference stacks
#: along a leading axis (its ``[R, ...]`` leaves)
STACKED_KEYS = ("blocks",)


def _slstm_ff(d: int) -> int:
    """4/3 * d rounded up to 128, as the reference sizes it."""
    return ((int(SLSTM_FF * d) + 127) // 128) * 128


def _pattern(cfg: ModelConfig) -> tuple[str, ...]:
    pat = cfg.xlstm_pattern or ("m",)
    if cfg.n_layers % len(pat):
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of the pattern {pat}")
    return pat


#: logical axes of the time loops' operands on a mesh: each rank runs its
#: batch rows whole (the loops mix every channel of a row)
SEQ_AXES = ("batch", "seq", None)
ROW_AXES = ("batch", None)
#: with shapes only (the ``meta`` device), the sLSTM's time loop and the
#: mLSTM's chunk loop run their first two steps and count the second once
#: for each later step (`device.meta_repeat`), forward and backward. Every
#: step after the first allocates and frees the same storages (the
#: outputs, and the states a gradient needs, go into buffers made before
#: the loop), so the FLOPs and the live and peak bytes are the whole
#: loop's. False runs every step, as on a card.
META_LOOP_BY_COUNT = True


def _steps(S: int, meta: bool, reverse: bool = False):
    """The time steps of a loop, in order; with shapes only (and
    META_LOOP_BY_COUNT) the first two, the second counted S - 1 times."""
    order = range(S - 1, -1, -1) if reverse else range(S)
    if not (meta and META_LOOP_BY_COUNT) or S <= 2:
        yield from order
        return
    yield order[0]
    with meta_repeat(S - 1):
        yield order[1]


# ------------------------------------------------------------------ mLSTM

def _mlstm_dims(cfg: ModelConfig):
    di = PROJ_FACTOR * cfg.d_model
    H = cfg.n_heads
    return di, H, di // H


def mlstm_block_init(gen: torch.Generator, cfg: ModelConfig):
    d, dt, dev = cfg.d_model, cfg.pdtype(), gen.device
    di, H, dh = _mlstm_dims(cfg)
    s = 1.0 / math.sqrt(dh)

    def bd():   # block-diagonal per-head projection [H, dh, dh]
        return (torch.randn((H, dh, dh), generator=gen, device=dev)
                * s).to(dt)

    return {
        "ln": L.norm_init(d, dt, cfg.norm_type, dev),
        "w_up": L.dense_init(gen, d, 2 * di, dt),
        "conv": torch.randn((cfg.conv_width, di), generator=gen,
                            device=dev).to(dt) * 0.1,
        "wq": bd(), "wk": bd(), "wv": bd(),
        "w_gate": L.dense_init(gen, di, 2 * H, torch.float32),
        "gate_bias": torch.tensor([1.0, -1.0] * H, dtype=torch.float32,
                                  device=dev),
        "gn": L.norm_init(di, dt, "rmsnorm", dev),
        "w_down": L.dense_init(gen, di, d, dt),
    }


def mlstm_block_axes(cfg: ModelConfig) -> dict:
    return {"ln": L.norm_axes(cfg.norm_type), "w_up": ("embed_fsdp", "rnn"),
            "conv": (None, "rnn"), "wq": (None, "rnn", None),
            "wk": (None, "rnn", None), "wv": (None, None, "rnn"),
            "w_gate": ("rnn", None), "gate_bias": (None,),
            "gn": L.norm_axes(), "w_down": ("rnn", "embed_fsdp")}


class MLSTMState(NamedTuple):
    C: torch.Tensor     # [B, H, dk, dv]
    n: torch.Tensor     # [B, H, dk]


def mlstm_scan(q, k, v, logf, logi, state: MLSTMState, chunk: int):
    """Chunkwise-parallel mLSTM.

    q, k: [B, S, H, dh]; v: [B, S, H, dv] (dv = dh, or a rank's columns
    of it: C's columns evolve apart); logf, logi: [B, S, H] (<= 0).
    Returns (out [B, S, H, dv], final state).
    """
    B, S, H, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, S)
    S0 = S
    pad = (-S) % chunk
    if pad:
        # identity steps: f = 1 (logf = 0) carries the state, i = 0
        # (logi = -1e30) adds nothing, so the final state is exact
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
        S = S + pad
    nc = S // chunk
    r = lambda x: x.reshape(B, nc, chunk, *x.shape[2:])
    C, n = state
    outs, C, n = _MLSTMScan.apply(*map(r, (q, k, v, logf, logi)), C, n,
                                  scale)
    return outs.reshape(B, S, H, v.shape[-1])[:, :S0], MLSTMState(C, n)


def _mlstm_chunk(qc, kc, vc, lf, li, C, n, scale: float):
    """One chunk of `mlstm_scan` from the state (C, n) before it: (out
    [B, c, H, dv], C, n after it)."""
    c = qc.shape[1]
    ti = torch.arange(c, device=qc.device)
    causal = (ti[:, None] >= ti[None, :])[None, :, :, None]
    Fc = torch.cumsum(lf, dim=1)                          # [B, c, H]
    # intra-chunk decay matrix A[t, s] = exp(F_t - F_s + li_s), s <= t
    logA = Fc[:, :, None] - Fc[:, None, :] + li[:, None, :]  # [B,t,s,H]
    A = torch.where(causal, torch.exp(logA), 0.0)
    scores = torch.einsum("bthd,bshd->btsh", qc, kc) * scale * A
    num = torch.einsum("btsh,bshd->bthd", scores, vc)
    # inter-chunk contribution of the carried state
    decay = torch.exp(Fc)                                 # [B, c, H]
    qCin = torch.einsum("bthd,bhde->bthe", qc, C) * scale
    num = num + decay[..., None] * qCin
    nvec = torch.einsum("btsh,bshd->bthd", scores / scale, kc) \
        + decay[..., None] * n[:, None]
    denom = torch.abs(torch.einsum("bthd,bthd->bth", qc, nvec)) * scale
    out = num / torch.clamp_min(denom, 1.0)[..., None]
    # the state at the chunk's end
    dAll = torch.exp(Fc[:, -1])                           # [B, H]
    w = torch.exp(Fc[:, -1][:, None] - Fc + li)           # [B, c, H]
    C = dAll[:, :, None, None] * C + \
        torch.einsum("bsh,bshd,bshe->bhde", w, kc, vc)
    n = dAll[:, :, None] * n + torch.einsum("bsh,bshd->bhd", w, kc)
    return out, C, n


class _MLSTMScan(torch.autograd.Function):
    """The mLSTM's loop over chunks, as `_SLSTMScan` runs the sLSTM's:
    forward chunk by chunk (`_mlstm_chunk`), the outputs written into a
    buffer made before the loop and, when a gradient is wanted, the state
    before each chunk into buffers of their own; backward chunk by chunk
    in reverse, each chunk recomputed from the state before it and
    differentiated by autograd. With shapes only (`_steps`), the first two
    chunks run and the second counts for the rest, forward and backward.
    Inputs [B, nc, c, ...] (the chunks along dim 1)."""

    @staticmethod
    def forward(ctx, qs, ks, vs, lfs, lis, C, n, scale):
        B, nc, c, H, _ = qs.shape
        keep = any(ctx.needs_input_grad)
        outs = qs.new_empty((B, nc, c, H, vs.shape[-1]))
        if keep:
            Cs = C.new_empty((B, nc) + tuple(C.shape[1:]))
            ns = n.new_empty((B, nc) + tuple(n.shape[1:]))
        for j in _steps(nc, qs.is_meta):
            if keep:
                Cs[:, j], ns[:, j] = C, n
            outs[:, j], C, n = _mlstm_chunk(qs[:, j], ks[:, j], vs[:, j],
                                            lfs[:, j], lis[:, j], C, n,
                                            scale)
        if keep:
            ctx.save_for_backward(qs, ks, vs, lfs, lis, Cs, ns)
            ctx.scale = scale
        return outs, C, n

    @staticmethod
    def backward(ctx, douts, dC, dn):
        *ins, Cs, ns = ctx.saved_tensors
        grads = [torch.zeros_like(x) for x in ins]
        carry = [torch.zeros_like(Cs[:, 0]) if dC is None else dC,
                 torch.zeros_like(ns[:, 0]) if dn is None else dn]
        for j in _steps(ins[0].shape[1], ins[0].is_meta, reverse=True):
            with torch.enable_grad():
                xs = [x[:, j].detach().requires_grad_()
                      for x in (*ins, Cs, ns)]
                out = _mlstm_chunk(*xs, ctx.scale)
                up = [torch.zeros_like(out[0]) if douts is None
                      else douts[:, j]] + carry
                g = torch.autograd.grad(out, xs, up)
            for buf, gj in zip(grads, g[:5]):
                buf[:, j] = gj
            carry = list(g[5:])
        return (*grads, *carry, None)


def mlstm_forward(p, cfg: ModelConfig, pol: Policy, x, state=None,
                  return_state: bool = False):
    """x: [B, S, d]. The mLSTM block body (everything but the residual).
    state = (MLSTMState, conv tail [B, W-1, di]) or None. On a mesh the up
    projection is gathered whole (its u and z halves lie on different
    ranks), the block's core runs on each rank's batch rows with its
    parameters gathered (`_mlstm_core`: plain tensors, the chunk loop
    without DTensor's dispatch), and the down projection's partial sum is
    all-reduced, as the MLP's own."""
    h = L.apply_norm(p["ln"], x, cfg.norm_eps, cfg.norm_type)
    up = pol.constrain(h @ p["w_up"], *SEQ_AXES)
    if state is not None and x.shape[1] == 1 and partitioning.is_dtensor(up):
        y, state = _mlstm_decode_sharded(p, cfg, pol, up, state, x.dtype)
        return (y, state) if return_state else y
    cell_state, conv_state = state if state is not None else (None, None)
    C0, n0 = (None, None) if cell_state is None else cell_state
    names = ("conv", "wq", "wk", "wv", "w_gate", "gate_bias")
    weights = [p[k] for k in names] + [p["gn"]["scale"]]
    g, C1, n1, conv_state = L.on_shards(
        functools.partial(_mlstm_core, cfg=cfg, dtype=x.dtype), pol,
        (SEQ_AXES,) + tuple((None,) * w.dim() for w in weights)
        + (("batch", None, None, None), ("batch", None, None),
           ("batch", None, None)),
        [SEQ_AXES, ("batch", None, None, None), ("batch", None, None),
         ("batch", None, None)],
        up, *weights, C0, n0, conv_state)
    y = pol.constrain(g @ p["w_down"], "batch", "seq", None)
    return (y, (MLSTMState(C1, n1), conv_state)) if return_state else y


def _mlstm_core(up, conv, wq, wk, wv, w_gate, gate_bias, gn, C, n,
                conv_state, cfg: ModelConfig, dtype):
    """The mLSTM block between its projections, on plain tensors (a rank's
    batch rows on a mesh): the causal conv, the q / k / v and gate
    projections, `mlstm_scan` in float32 (from the zero state where C is
    None), the group norm and the output gate. Returns (out * silu(z)
    [B, S, di], C, n, the conv tail)."""
    B, S, _ = up.shape
    di, H, dh = _mlstm_dims(cfg)
    u, z = up.chunk(2, dim=-1)                          # [B, S, di] each
    cv, conv_state = L.causal_conv(u, conv, conv_state)
    c = F.silu(cv)
    cH = c.reshape(B, S, H, dh)
    uH = u.reshape(B, S, H, dh)
    q = torch.einsum("bshd,hde->bshe", cH, wq)
    k = torch.einsum("bshd,hde->bshe", cH, wk) / math.sqrt(dh)
    v = torch.einsum("bshd,hde->bshe", uH, wv)
    gates = c.float() @ w_gate + gate_bias
    logf = F.logsigmoid(gates[..., :H])
    logi = F.logsigmoid(gates[..., H:])
    if C is None:
        C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=up.device)
        n = torch.zeros((B, H, dh), dtype=torch.float32, device=up.device)
    out, (C, n) = mlstm_scan(q.float(), k.float(), v.float(), logf, logi,
                             MLSTMState(C, n), cfg.mlstm_chunk)
    out = out.reshape(B, S, di).to(dtype)
    out = L.apply_norm({"scale": gn}, out, cfg.norm_eps, "rmsnorm")
    return out * F.silu(z), C, n, conv_state


#: logical axes of a decode step's state on a mesh: C [B, H, dk, dv] with
#: its dv columns on "rnn" (the cache's), n [B, H, dk] whole on each rank
C_AXES = ("batch", None, None, "rnn")
N_AXES = ("batch", None, None)
CONV_AXES = ("batch", None, "rnn")
RNN_AXES = ("batch", "seq", "rnn")
HEAD_AXES = ("batch", "seq", None, None)     # q, k [B, 1, H, dk], whole
V_AXES = ("batch", "seq", None, "rnn")       # v and the output's dv columns


def _block_of(n: int, axis):
    """This rank's (first index, count) of a dim of `n` split over the
    mesh axis `axis` (DTensor's even split; the whole dim for None)."""
    if axis is None:
        return 0, n
    mesh = partitioning.current_mesh()
    size = -(-n // mesh.size(mesh.mesh_dim_names.index(axis)))
    return mesh.get_local_rank(axis) * size, size


def _mlstm_decode_sharded(p, cfg: ModelConfig, pol: Policy, up, state,
                          dtype):
    """One mLSTM decode step on a mesh with C and n never leaving their
    rank: the C update (k outer v), C q (a contraction over dk) and n are
    local to a rank's dv columns once q and k are whole. `up` [B, 1, 2di]
    is whole on each rank. In four local steps (`layers.on_shards`): the
    causal conv of this rank's di channels (its conv tail's), gathered;
    the gates, q and k as partial sums over this rank's rows of w_gate,
    wq and wk (one all-reduce of the three, float32) and v's dv columns;
    `mlstm_scan` on the dv columns, the group norm's sum of squares a
    partial sum (one all-reduce); the normed output times silu(z),
    gathered for the down projection, whose partial sum is all-reduced.
    Only token-sized tensors [B/data, 1, ...] cross ranks."""
    di, H, dh = _mlstm_dims(cfg)
    (C, n), conv_state = state
    conv_state = pol.constrain(conv_state, *CONV_AXES)
    c0, _ = _block_of(di, pol.rules["rnn"])

    def conv(up, w, tail):
        u = up[..., :di]
        cv, tail = L.causal_conv(u[..., c0:c0 + w.shape[1]], w, tail)
        return F.silu(cv), tail

    c, conv_state = L.on_shards(conv, pol, (SEQ_AXES, (None, "rnn"),
                                            CONV_AXES),
                                [RNN_AXES, CONV_AXES], up, p["conv"],
                                conv_state)
    c = pol.constrain(c, *SEQ_AXES)
    r0, _ = _block_of(dh, pol.rules["rnn"])

    def proj(c, up, w_gate, wq, wk, wv):
        B, S, _ = c.shape
        cH = c.reshape(B, S, H, dh)
        rows = cH[..., r0:r0 + wq.shape[1]].float()
        gates = c[..., c0:c0 + w_gate.shape[0]].float() @ w_gate
        q = torch.einsum("bshd,hde->bshe", rows, wq.float())
        k = torch.einsum("bshd,hde->bshe", rows, wk.float())
        v = torch.einsum("bshd,hde->bshe", up[..., :di].reshape(B, S, H, dh),
                         wv)
        return torch.cat([gates, q.reshape(B, S, -1), k.reshape(B, S, -1)],
                         -1), v

    part, v = L.on_shards(proj, pol, (SEQ_AXES, SEQ_AXES, ("rnn", None),
                                      (None, "rnn", None), (None, "rnn", None),
                                      (None, None, "rnn")),
                          [L.Summed(SEQ_AXES), V_AXES], c, up, p["w_gate"],
                          p["wq"], p["wk"], p["wv"])
    part = pol.constrain(part, *SEQ_AXES)

    def cell(part, v, C, n, gate_bias):
        B, S, _ = part.shape
        gates = part[..., :2 * H] + gate_bias
        q = part[..., 2 * H:2 * H + H * dh].reshape(B, S, H, dh).to(dtype)
        k = (part[..., 2 * H + H * dh:].reshape(B, S, H, dh)
             / math.sqrt(dh)).to(dtype)
        logf = F.logsigmoid(gates[..., :H])
        logi = F.logsigmoid(gates[..., H:])
        out, (C, n) = mlstm_scan(q.float(), k.float(), v.float(), logf, logi,
                                 MLSTMState(C, n), cfg.mlstm_chunk)
        out = out.to(dtype)
        return out, C, n, (out.float() ** 2).sum((2, 3), keepdim=True)

    out, C, n, sq = L.on_shards(
        cell, pol, (SEQ_AXES, V_AXES, C_AXES, N_AXES, (None,)),
        [V_AXES, C_AXES, N_AXES, L.Summed(HEAD_AXES)], part, v, C, n,
        p["gate_bias"])
    sq = pol.constrain(sq, *HEAD_AXES)

    def gate_out(out, sq, gn, up):
        B, S, _, cols = out.shape
        # the group norm over all di (the reference's rmsnorm), then
        # out * silu(z), on this rank's dv columns of every head
        e0, _ = _block_of(dh, pol.rules["rnn"])
        pick = lambda t: t.reshape(B, S, H, dh)[..., e0:e0 + cols] if \
            t.dim() == 3 else t.reshape(H, dh)[:, e0:e0 + cols]
        y = out.float() * torch.rsqrt(sq[..., 0, 0][..., None, None] / di
                                      + cfg.norm_eps) * pick(gn).float()
        return y.to(dtype) * F.silu(pick(up[..., di:]))

    g = L.on_shards(gate_out, pol, (V_AXES, HEAD_AXES, (None,), SEQ_AXES),
                    V_AXES, out, sq, p["gn"]["scale"], up)
    g = pol.constrain(g, *HEAD_AXES)
    B, S = g.shape[:2]
    y = pol.constrain(g.reshape(B, S, di) @ p["w_down"], "batch", "seq", None)
    return y, (MLSTMState(C, n), conv_state)


# ------------------------------------------------------------------ sLSTM

def slstm_block_init(gen: torch.Generator, cfg: ModelConfig):
    d, dt, dev = cfg.d_model, cfg.pdtype(), gen.device
    H = cfg.n_heads
    dh = d // H
    ff = _slstm_ff(d)
    w = (torch.randn((d, 4 * d), generator=gen, device=dev)
         / math.sqrt(d)).to(dt)
    # block-diagonal recurrence [H, dh, 4 * dh]
    r = (torch.randn((H, dh, 4 * dh), generator=gen, device=dev)
         / math.sqrt(dh)).to(dt)
    return {
        "ln": L.norm_init(d, dt, cfg.norm_type, dev),
        "w": w,
        "r": r,
        "bias": torch.zeros((4 * d,), dtype=torch.float32, device=dev),
        "gn": L.norm_init(d, dt, "rmsnorm", dev),
        "up": L.dense_init(gen, d, 2 * ff, dt),
        "down": L.dense_init(gen, ff, d, dt),
    }


def slstm_block_axes(cfg: ModelConfig) -> dict:
    return {"ln": L.norm_axes(cfg.norm_type), "w": ("embed_fsdp", "rnn"),
            "r": (None, None, "rnn"), "bias": (None,), "gn": L.norm_axes(),
            "up": ("embed_fsdp", "mlp"), "down": ("mlp", "embed_fsdp")}


class SLSTMState(NamedTuple):
    h: torch.Tensor     # [B, d]
    c: torch.Tensor     # [B, d]
    n: torch.Tensor     # [B, d]
    m: torch.Tensor     # [B, d]  running log-max stabiliser


def _slstm_step(wx_t, r, bias, h, c, n, m):
    """One sLSTM step: wx_t [B, 4d], r [H, dh, 4dh], the state [B, d]."""
    B, d = h.shape
    H, dh = r.shape[0], r.shape[1]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh), r).reshape(
        B, 4 * d)
    pre = wx_t + rec + bias
    zt, it, ft, ot = pre.chunk(4, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    m_new = torch.maximum(ft + m, it)             # exp-gating stabiliser
    i = torch.exp(it - m_new)
    f = torch.exp(ft + m - m_new)
    c = f * c + i * z
    n = f * n + i
    h = o * c / torch.clamp_min(n, 1.0)
    return h, c, n, m_new


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM's time loop: forward step by step, each step's state
    written into ``[B, S, d]`` buffers made before the loop (h always; c,
    n and m too when a gradient is wanted); backward step by step in
    reverse, each step recomputed from the state before it and
    differentiated by autograd: the operations of autograd through the
    loop, one step at a time."""

    @staticmethod
    def forward(ctx, wx, r, bias, h, c, n, m):
        B, S, _ = wx.shape
        keep = any(ctx.needs_input_grad)
        bufs = [wx.new_empty((B, S, h.shape[1])) for _ in range(4 if keep
                                                                else 1)]
        state = (h, c, n, m)
        for t in _steps(S, wx.is_meta):
            state = _slstm_step(wx[:, t], r, bias, *state)
            for buf, x in zip(bufs, state):
                buf[:, t] = x
        if keep:
            ctx.save_for_backward(wx, r, bias, h, c, n, m, *bufs)
        return (bufs[0], *state)

    @staticmethod
    def backward(ctx, dhs, *dstate):
        wx, r, bias, *first, hs, cs, ns, ms = ctx.saved_tensors
        dwx = torch.zeros_like(wx)
        dr = torch.zeros_like(r)
        dbias = torch.zeros_like(bias)
        carry = [torch.zeros_like(first[0]) if g is None else g
                 for g in dstate]
        for t in _steps(wx.shape[1], wx.is_meta, reverse=True):
            prev = first if t == 0 else [x[:, t - 1] for x in (hs, cs, ns,
                                                                ms)]
            if dhs is not None:
                carry[0] = carry[0] + dhs[:, t]
            with torch.enable_grad():
                ins = [x.detach().requires_grad_()
                       for x in (wx[:, t], r, bias, *prev)]
                g = torch.autograd.grad(_slstm_step(*ins), ins, carry)
            dwx[:, t] = g[0]
            dr += g[1]
            dbias += g[2]
            carry = list(g[3:])
        return (dwx, dr, dbias, *carry)


def _slstm_local(wx, r, bias, h, c, n, m):
    """The time loop in float32 on plain tensors (a rank's batch rows on a
    mesh). A state of None is the zero state (m = -1e9)."""
    if h is None:
        B, d = wx.shape[0], wx.shape[2] // 4
        h = c = n = torch.zeros((B, d), dtype=torch.float32, device=wx.device)
        m = torch.full((B, d), -1e9, dtype=torch.float32, device=wx.device)
    return _SLSTMScan.apply(wx.float(), r.float(), bias, h, c, n, m)


def slstm_seq(p, cfg: ModelConfig, pol: Policy, wx, state=None):
    """wx: [B, S, 4d] precomputed input projections; a loop over time in
    float32 from `state` (None: the zero state). Returns (h [B, S, d],
    final state). On a mesh, `wx` and the recurrence are gathered along
    "model" once, and each rank runs its batch rows' loop on plain
    tensors."""
    st = (None,) * 4 if state is None else tuple(state)
    hs, *fin = L.on_shards(
        _slstm_local, pol,
        (SEQ_AXES, (None, None, None), (None,)) + (ROW_AXES,) * 4,
        [SEQ_AXES] + [ROW_AXES] * 4, wx, p["r"], p["bias"], *st)
    return hs, SLSTMState(*fin)


def slstm_forward(p, cfg: ModelConfig, pol: Policy, x, state=None,
                  return_state: bool = False):
    """x: [B, S, d]. The sLSTM block body with its post-up GeGLU MLP."""
    h = L.apply_norm(p["ln"], x, cfg.norm_eps, cfg.norm_type)
    wx = h @ p["w"]
    hs, state = slstm_seq(p, cfg, pol, wx, state)
    hs = L.apply_norm(p["gn"], hs.to(x.dtype), cfg.norm_eps, "rmsnorm")
    # on a mesh the up projection's halves lie on different ranks: gathered
    a, b = pol.constrain(hs @ p["up"], *SEQ_AXES).chunk(2, dim=-1)
    y = (F.gelu(a, approximate="tanh") * b) @ p["down"]  # jax.nn.gelu's
    # a partial sum over "mlp" on a mesh: all-reduced, as the MLP's own
    y = pol.constrain(y, "batch", "seq", None)
    return (y, state) if return_state else y


# ------------------------------------------------------------------ model

def init_params(cfg: ModelConfig, pol: Policy, gen: torch.Generator):
    """Random parameters on `gen`'s device, drawn from `gen` in a fixed
    order (embedding, then the repeats block by block)."""
    pat = _pattern(cfg)
    reps = cfg.n_layers // len(pat)

    def superblock():
        return {f"b{i}_{t}": (mlstm_block_init(gen, cfg) if t == "m"
                              else slstm_block_init(gen, cfg))
                for i, t in enumerate(pat)}

    return {
        "embed": L.embed_init(gen, L.padded_vocab(cfg), cfg.d_model,
                              cfg.pdtype()),
        "blocks": [superblock() for _ in range(reps)],
        "norm": L.norm_init(cfg.d_model, cfg.pdtype(), cfg.norm_type,
                            gen.device),
    }


def param_axes(cfg: ModelConfig, pol: Policy) -> dict:
    """The logical axes of every leaf of `init_params`' tree (the
    reference's `Boxed` axes, without the leading "layers" of the
    repeats)."""
    pat = _pattern(cfg)
    block = {"m": mlstm_block_axes, "s": slstm_block_axes}
    return {"embed": L.EMBED_AXES,
            "blocks": [{f"b{i}_{t}": block[t](cfg) for i, t in enumerate(pat)}
                       for _ in range(cfg.n_layers // len(pat))],
            "norm": L.norm_axes(cfg.norm_type)}


def forward(cfg: ModelConfig, pol: Policy, params, tokens, embeds=None):
    """Full-sequence forward. Returns (hidden [B,S,d] post-final-norm,
    aux_loss = 0). `embeds` is not read, as in the reference."""
    pat = _pattern(cfg)
    x = L.embed_lookup(cfg, pol, params["embed"], tokens)

    def body(x, bp):
        for i, t in enumerate(pat):
            block = mlstm_forward if t == "m" else slstm_forward
            x = x + block(bp[f"b{i}_{t}"], cfg, pol, x)
        return x

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for bp in params["blocks"]:
        # nothing in a block draws random numbers: no RNG state to replay
        x = (checkpoint(body, x, bp, use_reentrant=False,
                        preserve_rng_state=False) if remat else body(x, bp))
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


@dataclasses.dataclass(frozen=True)
class XLSTMCache:
    """Decode state, O(1) in the context length. A family with no block of
    one kind keeps one placeholder layer of it, as the reference does."""
    mC: torch.Tensor      # [n_m, B, H, dh, dh] mLSTM matrix memories
    mn: torch.Tensor      # [n_m, B, H, dh]
    mconv: torch.Tensor   # [n_m, B, W-1, di] causal-conv tails
    sh: torch.Tensor      # [n_s, B, d] sLSTM h, c, n, m
    sc: torch.Tensor
    sn: torch.Tensor
    sm: torch.Tensor
    pos: int              # absolute position of the next token


def init_cache(cfg: ModelConfig, pol: Policy, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> XLSTMCache:
    """Zero state (m = -1e9) at position 0, in `dtype` (float32 by
    default, as the reference's). `max_len` is not read: the state does
    not grow. ``device=None`` means the card (raises without one)."""
    dev = resolve_device(device)
    pat = _pattern(cfg)
    reps = cfg.n_layers // len(pat)
    di, H, dh = _mlstm_dims(cfg)
    n_m = max(reps * pat.count("m"), 1)
    n_s = max(reps * pat.count("s"), 1)
    d = cfg.d_model
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    return XLSTMCache(
        mC=z(n_m, batch, H, dh, dh), mn=z(n_m, batch, H, dh),
        mconv=z(n_m, batch, cfg.conv_width - 1, di),
        sh=z(n_s, batch, d), sc=z(n_s, batch, d), sn=z(n_s, batch, d),
        sm=torch.full((n_s, batch, d), -1e9, dtype=dtype, device=dev),
        pos=0)


def cache_axes(cfg: ModelConfig) -> XLSTMCache:
    """The logical axes of `init_cache`'s tensors, the reference's
    (`xlstm.py:362-369`): C's dv columns on "rnn"."""
    row = ("layers", "batch", None)
    return XLSTMCache(mC=("layers",) + C_AXES, mn=("layers",) + N_AXES,
                      mconv=("layers",) + CONV_AXES, sh=row, sc=row, sn=row,
                      sm=row, pos=())


def decode_step(cfg: ModelConfig, pol: Policy, params, cache: XLSTMCache,
                tokens):
    """One-token decode: recurrent state only. tokens: [B, 1]. Returns
    (logits [B,1,V], cache): each block's new state is written into its
    cache slot in place (rounded to the cache's dtype, as the reference
    casts it) and the cache returned with ``pos + 1``."""
    pat = _pattern(cfg)
    x = L.embed_lookup(cfg, pol, params["embed"], tokens)
    mi = si = 0
    for bp in params["blocks"]:
        for i, t in enumerate(pat):
            p = bp[f"b{i}_{t}"]
            if t == "m":
                st = (MLSTMState(cache.mC[mi], cache.mn[mi]), cache.mconv[mi])
                y, (cell, conv) = mlstm_forward(p, cfg, pol, x, state=st,
                                                return_state=True)
                # each new state on its cache slice's axes (on a mesh)
                cache.mC[mi].copy_(pol.constrain(cell.C, *C_AXES))
                cache.mn[mi].copy_(pol.constrain(cell.n, *N_AXES))
                cache.mconv[mi].copy_(pol.constrain(conv, *CONV_AXES))
                mi += 1
            else:
                st = SLSTMState(cache.sh[si], cache.sc[si], cache.sn[si],
                                cache.sm[si])
                y, st = slstm_forward(p, cfg, pol, x, state=st,
                                      return_state=True)
                for slot, new in zip((cache.sh, cache.sc, cache.sn,
                                      cache.sm), st):
                    slot[si].copy_(pol.constrain(new, *ROW_AXES))
                si += 1
            x = x + y
    x = L.apply_norm(params["norm"], x, cfg.norm_eps, cfg.norm_type)
    logits = L.unembed(cfg, pol, x, params["embed"])
    return logits, dataclasses.replace(cache, pos=cache.pos + 1)
