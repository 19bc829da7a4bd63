"""Mixture-of-Experts layer, in PyTorch: sort/gather dispatch (default) and
the GShard one-hot einsum.

The counterpart of the reference's `repro/models/moe.py`. The router and
the expert stack are ``E = pol.expert_pad or cfg.n_experts`` wide:
`single_device_policy` sets ``expert_pad = n_experts``, and a policy
resolved for an expert-parallel mesh pads E to a multiple of its model
axis (qwen2-moe-a2.7b's 60 experts to 64 on a 16-wide axis); the dead
experts' router logits are masked to -1e30, as the reference masks them,
so they receive no token.

Two dispatch implementations, selected by ``impl``:

  * ``gather`` (what ``"auto"`` resolves to unless the policy maps the
    expert axis) — each batch row
    is a routing group: its (token, choice) pairs, in the flattened (s, k)
    order, are ranked within their expert by an exclusive running count,
    scattered into an ``[E * C + 1, d]`` buffer whose last row is the drop
    bin, run through the SwiGLU experts and gathered back, each weighted by
    ``gate * keep``. Linear in tokens.
  * ``einsum`` — the GShard one-hot formulation, ``[B, S, E, C]`` dispatch
    and combine tensors; ``"auto"`` takes it when ``pol.rules["expert"]``
    names a mesh axis, as the reference's does.

Both drop the choices past an expert's capacity C = ceil(S * k / E * cf)
(combine weight 0; the residual path carries the token), as in
Switch / GShard. The drop bin is written once for every dropped choice, in
no fixed order; it is discarded, and every kept slot is written once.

Top-k is a stable descending sort, so that ties go to the lower expert
index, as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order).
The expert products are `torch.einsum`, as the reference leaves them to
XLA: no TPU kernel lies on this path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NEG_INF, dense_init
from repro_torch.sharding.policy import Policy

IMPLS = ("auto", "gather", "einsum")


def moe_axes() -> dict:
    """Logical axes of `moe_init`'s leaves."""
    return {"router": ("embed", "expert"),
            "wi": ("expert", "embed_fsdp", None),
            "wg": ("expert", "embed_fsdp", None),
            "wo": ("expert", None, "embed_fsdp")}


def moe_init(gen: torch.Generator, cfg: ModelConfig, pol: Policy):
    """Router ``[d, E]`` (E the padded expert count) in float32 at scale
    0.02 and the stacked SwiGLU
    experts ``wi`` / ``wg`` ``[E, d, f]``, ``wo`` ``[E, f, d]``, each drawn
    in float32 times 1/sqrt(d) (one expert at a time, so that no float32
    copy of a whole stack is held) and cast to the param dtype."""
    E = pol.expert_pad or cfg.n_experts
    d, f, dt = cfg.d_model, cfg.expert_d_ff, cfg.pdtype()
    s = 1.0 / math.sqrt(d)
    router = dense_init(gen, d, E, torch.float32, scale=0.02)

    def ex(shape):
        w = torch.empty((E,) + shape, dtype=dt, device=gen.device)
        if w.device.type == "meta":     # a shape-only build draws nothing
            return w
        for e in range(E):
            w[e] = torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen.device) * s
        return w

    return {"router": router, "wi": ex((d, f)), "wg": ex((d, f)),
            "wo": ex((f, d))}


def capacity(S: int, top_k: int, E: int, cf: float) -> int:
    return max(1, int(math.ceil(S * top_k / E * cf)))


def _route(p, cfg: ModelConfig, x):
    """Router: returns (gate [B,S,k], idx [B,S,k], probs [B,S,E])."""
    E = p["router"].shape[-1]
    k = cfg.experts_per_token
    logits = x.float() @ p["router"]                       # [B, S, E]
    if E > cfg.n_experts:                                  # mask padded experts
        live = torch.arange(E, device=x.device) < cfg.n_experts
        logits = logits.masked_fill(~live, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index, as jax.lax.top_k
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :k], order[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, idx, probs


def _aux_loss(cfg: ModelConfig, idx, probs, E: int):
    """Switch-style load-balance loss: E * sum_e fraction_e * mean_prob_e."""
    oh = F.one_hot(idx, E).float()                         # [B, S, k, E]
    frac = oh.sum(2).reshape(-1, E).mean(0)
    mean_p = probs.reshape(-1, E).mean(0)
    return cfg.n_experts * torch.sum(frac * mean_p)


def _experts(p, xin, spec: str):
    """SwiGLU of every expert over its slice of `xin` (the expert axis is
    `spec`'s letter e), in `xin`'s dtype."""
    dt = xin.dtype
    out = spec.replace("d", "f")
    h = F.silu(torch.einsum(f"{spec},edf->{out}", xin, p["wg"].to(dt))) \
        * torch.einsum(f"{spec},edf->{out}", xin, p["wi"].to(dt))
    return torch.einsum(f"{out},efd->{spec}", h, p["wo"].to(dt))


def moe_forward(p, cfg: ModelConfig, pol: Policy, x, impl: str = "auto"):
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar). ``"auto"`` is
    ``"einsum"`` when the policy maps the expert axis (experts sharded
    over a mesh: dispatch and combine as all-to-alls), else ``"gather"``,
    as the reference's."""
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        impl = "einsum" if pol.rules.get("expert") is not None else "gather"
    if impl == "einsum":
        return moe_forward_einsum(p, cfg, pol, x)
    return moe_forward_gather(p, cfg, pol, x)


def moe_forward_gather(p, cfg: ModelConfig, pol: Policy, x):
    """Sort-based dispatch, batch row by batch row: linear memory and
    FLOPs in tokens."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    k = cfg.experts_per_token
    C = capacity(S, k, E, cfg.capacity_factor)
    dt = x.dtype
    gate, idx, probs = _route(p, cfg, x)

    eid = idx.reshape(B, S * k)
    oh = F.one_hot(eid, E)                                 # [B, S*k, E]
    rank = (torch.cumsum(oh, dim=1) - oh).gather(2, eid[..., None])[..., 0]
    keep = rank < C
    slot = torch.where(keep, eid * C + rank, E * C)        # E*C = drop bin
    rows = torch.arange(B, device=x.device)[:, None]
    buf = x.new_zeros((B, E * C + 1, d))
    buf[rows, slot] = x.repeat_interleave(k, dim=1)        # choice j -> s // k
    xin = buf[:, :E * C].reshape(B, E, C, d)
    eo = _experts(p, xin, "becd")                          # [B, E, C, d]

    flat = torch.cat([eo.reshape(B, E * C, d), eo.new_zeros((B, 1, d))], 1)
    w = (gate.float().reshape(B, S * k) * keep).to(dt)
    out = (flat[rows, slot] * w[..., None]).reshape(B, S, k, d).sum(2)
    return out, _aux_loss(cfg, idx, probs, E)


def moe_forward_einsum(p, cfg: ModelConfig, pol: Policy, x):
    """GShard one-hot dispatch (the reference's baseline formulation)."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    k = cfg.experts_per_token
    C = capacity(S, k, E, cfg.capacity_factor)
    dt = x.dtype
    gate, idx, probs = _route(p, cfg, x)

    # position of each (token, choice) within its expert's capacity buffer
    flat = F.one_hot(idx, E).float().reshape(B, S * k, E)
    pos = torch.cumsum(flat, dim=1) - flat                 # [B, S*k, E]
    keep = (pos < C).float() * flat
    # one-hot over C; a position past C gives a zero row, as jax.nn.one_hot
    at = (pos * flat).sum(-1).long()
    slot = (at[..., None] == torch.arange(C, device=x.device)).float()
    gk = gate.reshape(B, S * k, 1) * keep                  # [B, S*k, E]
    combine = torch.einsum("bte,btc->btec", gk, slot).reshape(
        B, S, k, E, C).sum(2)                              # [B, S, E, C]
    dispatch = (combine > 0).to(dt)

    xin = torch.einsum("bsec,bsd->ebcd", dispatch, x)      # [E, B, C, d]
    eo = _experts(p, xin, "ebcd")
    out = torch.einsum("bsec,ebcd->bsd", combine.to(dt), eo)
    return out, _aux_loss(cfg, idx, probs, E)
