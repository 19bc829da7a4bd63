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

On a mesh either dispatch runs on each rank's local shards
(`_moe_on_shards`): the routes of its batch rows from the router's logits
gathered over the experts, its experts only, the combined output a
partial sum over the experts made whole by one all-reduce; one card runs
the same code over every expert. The train step runs it on a mesh under
``tp`` (the batch over "data" alone, the experts on "model"): the aux
loss's gradient reaches the router once, through each rank's own
experts' columns.

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
from repro_torch.sharding import partitioning
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
    return _route_logits(cfg, x.float() @ p["router"])


def _route_logits(cfg: ModelConfig, logits):
    """`_route` from the router's float32 logits [B, S, E]."""
    E = logits.shape[-1]
    k = cfg.experts_per_token
    if E > cfg.n_experts:                                  # mask padded experts
        live = torch.arange(E, device=logits.device) < cfg.n_experts
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


def moe_forward(p, cfg: ModelConfig, pol: Policy, x, impl: str = "auto",
                aux: bool = True):
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar; None where `aux`
    is False, as a decode step discards it). ``"auto"`` is ``"einsum"``
    when the policy maps the expert axis (experts sharded over a mesh),
    else ``"gather"``, as the reference's. On a mesh the dispatch runs on
    each rank's local shards (`_moe_on_shards`)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        impl = "einsum" if pol.rules.get("expert") is not None else "gather"
    if partitioning.is_dtensor(x):
        return _moe_on_shards(p, cfg, pol, x, impl, aux)
    if impl == "einsum":
        return moe_forward_einsum(p, cfg, pol, x, aux)
    return moe_forward_gather(p, cfg, pol, x, aux)


def moe_forward_gather(p, cfg: ModelConfig, pol: Policy, x,
                       aux: bool = True):
    """Sort-based dispatch, batch row by batch row: linear memory and
    FLOPs in tokens."""
    E = p["router"].shape[-1]
    gate, idx, probs = _route(p, cfg, x)
    out = _dispatch_gather(p, cfg, x, gate, idx, E)
    return out, (_aux_loss(cfg, idx, probs, E) if aux else None)


def moe_forward_einsum(p, cfg: ModelConfig, pol: Policy, x,
                       aux: bool = True):
    """GShard one-hot dispatch (the reference's baseline formulation)."""
    E = p["router"].shape[-1]
    gate, idx, probs = _route(p, cfg, x)
    out = _dispatch_einsum(p, cfg, x, gate, idx, E)
    return out, (_aux_loss(cfg, idx, probs, E) if aux else None)


def _dispatch_gather(p, cfg: ModelConfig, x, gate, idx, E: int, e0: int = 0):
    """The gather dispatch of x [B, S, d] by its routes, through the
    experts of `p` (E0 of them, the experts e0 .. e0 + E0 - 1 of E, all
    by default): choices routed elsewhere weigh 0, so that on a mesh the
    result is this rank's partial sum over the experts."""
    B, S, d = x.shape
    k = cfg.experts_per_token
    C = capacity(S, k, E, cfg.capacity_factor)
    E0 = p["wi"].shape[0]
    dt = x.dtype
    eid = idx.reshape(B, S * k)
    oh = F.one_hot(eid, E)                                 # [B, S*k, E]
    rank = (torch.cumsum(oh, dim=1) - oh).gather(2, eid[..., None])[..., 0]
    keep = rank < C
    if E0 < E:                                             # this rank's
        keep &= (eid >= e0) & (eid < e0 + E0)
        eid = eid - e0
    slot = torch.where(keep, eid * C + rank, E0 * C)       # E0*C = drop bin
    rows = torch.arange(B, device=x.device)[:, None]
    buf = x.new_zeros((B, E0 * C + 1, d))
    buf[rows, slot] = x.repeat_interleave(k, dim=1)        # choice j -> s // k
    xin = buf[:, :E0 * C].reshape(B, E0, C, d)
    eo = _experts(p, xin, "becd")                          # [B, E0, C, d]

    flat = torch.cat([eo.reshape(B, E0 * C, d), eo.new_zeros((B, 1, d))], 1)
    w = (gate.float().reshape(B, S * k) * keep).to(dt)
    return (flat[rows, slot] * w[..., None]).reshape(B, S, k, d).sum(2)


def _dispatch_einsum(p, cfg: ModelConfig, x, gate, idx, E: int, e0: int = 0):
    """The GShard one-hot dispatch of x [B, S, d], through the experts of
    `p` (E0 of them from e0, as `_dispatch_gather`)."""
    B, S, d = x.shape
    k = cfg.experts_per_token
    C = capacity(S, k, E, cfg.capacity_factor)
    E0 = p["wi"].shape[0]
    dt = x.dtype
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
    if E0 < E:                                             # this rank's
        combine = combine[:, :, e0:e0 + E0]
    dispatch = (combine > 0).to(dt)

    xin = torch.einsum("bsec,bsd->ebcd", dispatch, x)      # [E0, B, C, d]
    eo = _experts(p, xin, "ebcd")
    return torch.einsum("bsec,ebcd->bsd", combine.to(dt), eo)


#: logical axes of the expert stacks as a rank's dispatch takes them
EXPERT_AXES = ("expert", None, None)
ROWS = ("batch", "seq", None)


def _moe_on_shards(p, cfg: ModelConfig, pol: Policy, x, impl: str,
                   aux: bool):
    """The MoE layer on a mesh, on each rank's local shards
    (`layers.on_shards`): the router's logits gathered over "expert" once;
    the routes and the capacity ranks of this rank's batch rows; the
    dispatch through this rank's experts only, whose combined output is a
    partial sum over the experts, made whole by one all-reduce, as the
    MLP's output projection. The aux loss takes its two per-expert sums
    over the rows (one all-reduce over the batch's mesh axis, [2, E]
    float32). Every rank of the expert axis computes all E columns of
    those sums alike, but in the backward only its own experts' columns
    pass a gradient to the logits, whose gradient is a partial sum over
    that axis: else the aux term would reach the router (and `x`) once a
    rank. The batch's rows over more than one mesh axis (``dp_zero1`` /
    ``dp_zero3`` on data x model) raise: ROADMAP.md item 19b, step
    3b(ii)."""
    from repro_torch.models import layers as L

    E = p["router"].shape[-1]
    axis = pol.rules.get("expert")
    if axis is not None and not isinstance(axis, str):
        raise NotImplementedError(f"experts over {axis!r}")
    mesh = partitioning.current_mesh()
    e0 = 0 if axis is None else \
        mesh.get_local_rank(axis) * (E // mesh.size(
            mesh.mesh_dim_names.index(axis)))
    logits = pol.constrain(x.float() @ p["router"], *ROWS)

    def local(x, logits, wi, wg, wo):
        gate, idx, probs = _route_logits(cfg, logits)
        dispatch = _dispatch_einsum if impl == "einsum" else _dispatch_gather
        out = dispatch({"wi": wi, "wg": wg, "wo": wo}, cfg, x, gate, idx, E,
                       e0)
        if not aux:
            return out
        sums = torch.stack([F.one_hot(idx, E).float().sum((0, 1, 2)),
                            probs.sum((0, 1))])
        E0 = wi.shape[0]
        if E0 < E:
            # every rank of the expert axis computes the same sums from the
            # same gathered logits (the value is replicated), but only its
            # own experts' columns carry a gradient, so that the logits'
            # partial gradients over that axis sum the aux term's once
            col = torch.arange(E, device=sums.device)
            sums = torch.where((col >= e0) & (col < e0 + E0), sums,
                               sums.detach())
        return out, sums

    out_axes = ROWS if axis is None else L.Summed(ROWS, axis)
    rows_over = pol.rules.get("batch")
    if rows_over is not None and not isinstance(rows_over, str):
        raise NotImplementedError(
            f"an MoE layer with its batch rows over {rows_over!r} "
            f"(dp_zero1 / dp_zero3) is not ported (ROADMAP.md item 19b, "
            f"step 3b(ii))")
    sums_axes = (None, None) if rows_over is None else \
        L.Summed((None, None), rows_over)
    got = L.on_shards(
        local, pol, (ROWS, ROWS) + (EXPERT_AXES,) * 3,
        [out_axes, sums_axes] if aux else out_axes,
        x, logits, p["wi"], p["wg"], p["wo"])
    out = pol.constrain(got[0] if aux else got, *ROWS)
    if not aux:
        return out, None
    sums = pol.constrain(got[1], None, None)
    n = x.shape[0] * x.shape[1]
    return out, cfg.n_experts * torch.sum((sums[0] / n) * (sums[1] / n))
