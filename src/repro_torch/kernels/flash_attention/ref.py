"""Plain PyTorch versions of flash attention (GQA, causal/local, softcap).

`attention_ref` is the function of the reference's
`repro/kernels/flash_attention/ref.py :: attention_ref`: the whole
``[Sq, Skv]`` score matrix in float32, masked against absolute positions
(query i sits at ``i + Skv - Sq``), softmax, product with V in float32,
output in ``q.dtype``.

`attention_bwd_ref` is its gradient, which the reference has no kernel
for: per block of queries it recomputes the probabilities P under the same
masks, then ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP - rowsum(P *
dP))`` (times ``1 - tanh^2`` under a soft-cap), ``dQ = dS K / sqrt(hd)``
and ``dK = dS^T Q / sqrt(hd)``, with dK and dV summed over the query heads
of each KV head. ``rowsum(P * dP)`` equals FlashAttention's ``rowsum(dO *
O)`` for the float32 O; it is taken from P so that the bf16 rounding of
the saved output does not enter. A block only reads the keys it can see,
so ``[B, H, Sq, Skv]`` is never held whole.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BWD_CHUNK = 512          # query rows per block of the backward


def _mask(q_pos, k_pos, causal: bool, window: int):
    mask = torch.ones((q_pos.numel(), k_pos.numel()), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """q: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd]. Returns [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    qg = q.reshape(B, Sq, KV, g, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) / math.sqrt(hd)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qi = torch.arange(Sq, device=q.device) + (Skv - Sq)
    ki = torch.arange(Skv, device=q.device)
    s = s.masked_fill(~_mask(qi, ki, causal, window), NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_bwd_ref(q, k, v, do, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, chunk: int = BWD_CHUNK):
    """Gradients of `attention_ref` for the output gradient ``do [B, Sq, H,
    hd]``. Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    off = Skv - Sq
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, Sq, chunk):
        n = min(chunk, Sq - c0)
        # the keys this block can see at all
        hi = min(Skv, c0 + n + off) if causal else Skv
        lo = max(0, c0 + off - window + 1) if window > 0 else 0
        qi = torch.arange(c0, c0 + n, device=q.device) + off
        ki = torch.arange(lo, hi, device=q.device)
        qg = q[:, c0:c0 + n].float().reshape(B, n, KV, g, hd)
        dog = do[:, c0:c0 + n].float().reshape(B, n, KV, g, hd)
        kc, vc = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bskgh,btkh->bkgst", qg, kc) * scale
        if softcap > 0:
            t = torch.tanh(s / softcap)
            s = t * softcap
        s = s.masked_fill(~_mask(qi, ki, causal, window), NEG_INF)
        p = torch.softmax(s, dim=-1)
        dp = torch.einsum("bskgh,btkh->bkgst", dog, vc)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        if softcap > 0:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq[:, c0:c0 + n] = torch.einsum(
            "bkgst,btkh->bskgh", ds, kc).reshape(B, n, H, hd)
        dk[:, lo:hi] += torch.einsum("bkgst,bskgh->btkh", ds, qg)
        dv[:, lo:hi] += torch.einsum("bkgst,bskgh->btkh", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
