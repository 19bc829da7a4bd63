"""AdamW with gradient clipping and LR schedules (self-contained).

The counterpart of the reference's `repro/train/optim.py`: linear warmup
then cosine decay, global-norm clipping, decoupled weight decay on
tensors of rank >= 2 (counted in the reference's stacked layout of the
keys the caller names, see `decay_mask`), float32 moments
(``moment_dtype``). Parameters, gradients and moments are nested dicts /
lists of tensors of one structure (`tree_leaves` walks them in one fixed
order). Unlike the
reference, which returns new trees, `apply` updates the parameters and
the moments IN PLACE, one tensor at a time: at recurrentgemma-2b's size a
second copy of the 19 GB of moments would not be free.

On a mesh the parameters are DTensors, and so are the moments
(`torch.zeros_like` keeps a parameter's placements, as the reference's
dry run lowers ``m=p_shard, v=p_shard``: under ``dp_zero3`` a quarter of
each block weight's on four cards, ``(Shard(d), Shard(d))``).
`reduce_to_params` first makes each gradient's placements its
parameter's, explicitly (an all-reduce of a partial sum over the batch's
axes where the parameter is replicated, a reduce-scatter where it is a
shard: one over both axes together onto ``dp_zero3``'s nested shard,
`partitioning.place`); `global_norm` sums the squares of each leaf's
local shard and makes the sum whole once for each set of sharded mesh
dims; `apply` then updates each leaf's local shard in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"     # "bfloat16" for very large models


class OptState(NamedTuple):
    step: int             # steps taken, a host integer
    m: list               # first moments, one per leaf of the parameters
    v: list               # second moments


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def decay_mask(params, stacked) -> list:
    """Per leaf (in `tree_leaves` order): does weight decay apply? Leaves of
    rank >= 2, counting one more axis under a key of `stacked`. The
    reference's default decays leaves of rank >= 2 in ITS layout, where a
    family's per-layer list (its module's ``STACKED_KEYS``) is one tensor
    stacked along a leading axis: a 1-D leaf of a stacked layer (a norm
    scale, the RG-LRU's ``lam``) is 2-D there and decays, while the same
    leaf of the hybrid tail or the final norm does not. Given the family's
    keys, the port keeps that rule, so that its steps are the reference's
    (ROADMAP.md, Queue 3)."""
    def walk(tree, extra: int):
        if isinstance(tree, dict):
            return [m for k in sorted(tree)
                    for m in walk(tree[k], extra + (k in stacked))]
        if isinstance(tree, (list, tuple)):
            return [m for t in tree for m in walk(t, extra)]
        return [tree.dim() + extra >= 2]
    return walk(params, 0)


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup then cosine decay to min_lr_frac."""
    if step < cfg.warmup_steps:
        return cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = min(max((step - cfg.warmup_steps) /
                   max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + math.cos(math.pi * prog))
    return cfg.lr * cos


def init(cfg: AdamWConfig, params) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    z = lambda p: torch.zeros_like(p, dtype=dt)
    leaves = tree_leaves(params)
    return OptState(step=0, m=[z(p) for p in leaves],
                    v=[z(p) for p in leaves])


def _local(x):
    """A DTensor's local shard (its storage: in-place ops on it update
    the DTensor); a plain tensor as it is."""
    return x._local_tensor if _is_dtensor(x) else x


def _is_dtensor(x) -> bool:
    from repro_torch.sharding.partitioning import is_dtensor
    return is_dtensor(x)


def reduce_to_params(grads, params) -> list:
    """Each gradient (in `tree_leaves` order) redistributed to its
    parameter's placements where both are DTensors: a partial sum over
    the batch's mesh axes all-reduced onto a replicated parameter, or
    reduce-scattered onto a shard (ZeRO-3's dims, where the gather at use
    has not already done so). Plain gradients as they are."""
    from repro_torch.sharding.partitioning import place

    return [place(g, p.device_mesh, p.placements)
            if _is_dtensor(g) else g
            for g, p in zip(tree_leaves(grads), tree_leaves(params))]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32. DTensor
    leaves: each local shard's sum of squares, summed over the leaves that
    shard the same mesh dims (whatever tensor dims they shard), is made
    whole once for each such set of mesh dims: one all-reduce over those
    dims together (`partitioning.sum_over`), none over the dims a leaf
    replicates, so that a replicated leaf counts once, not once a rank."""
    from repro_torch.sharding.partitioning import sum_over

    plain, groups = [], {}
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(_local(g).float()))
        if _is_dtensor(g):
            if any(p.is_partial() for p in g.placements):
                raise ValueError("a partial gradient: reduce it to its "
                                 "parameter's placements first "
                                 "(`reduce_to_params`)")
            dims = tuple(i for i, p in enumerate(g.placements)
                         if p.is_shard())
            groups.setdefault((g.device_mesh, dims), []).append(sq)
        else:
            plain.append(sq)
    total = [torch.stack(plain).sum()] if plain else []
    for (mesh, dims), sqs in groups.items():
        total.append(sum_over(torch.stack(sqs).sum(), mesh, dims))
    return torch.sqrt(torch.stack(total).sum() if len(total) > 1
                      else total[0])


@torch.no_grad()
def apply(cfg: AdamWConfig, state: OptState, params, grads, decay):
    """One AdamW step on `params` in place, weight decay where `decay` (a
    `decay_mask` of `params`) says. `grads` holds the gradients in
    `tree_leaves` order (or in the structure of `params`). Returns (params,
    new state, {"lr", "grad_norm"})."""
    step = state.step + 1
    gn = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp_min(gn, 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for p, g, m, v, dk in zip(tree_leaves(params), tree_leaves(grads),
                              state.m, state.v, decay):
        # the same placements on a mesh: elementwise on the local shards
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        g = g.float() * scale
        m32, v32 = m.float(), v.float()     # the moments themselves if f32
        m32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        upd = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay > 0 and dk:
            upd.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float().sub_(upd, alpha=lr))
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
    return params, OptState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gn}
