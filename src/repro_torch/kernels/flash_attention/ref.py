"""Plain PyTorch version of flash attention (GQA, causal/local, softcap).

The function of the reference's `repro/kernels/flash_attention/ref.py ::
attention_ref`: the whole ``[Sq, Skv]`` score matrix in float32, masked
against absolute positions (query i sits at ``i + Skv - Sq``), softmax,
product with V in float32, output in ``q.dtype``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
    qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
