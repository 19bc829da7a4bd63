"""Cross-entropy loss computed in sequence chunks.

The counterpart of the reference's `repro/train/loss.py`. For 100k-256k
vocabularies a whole [B, S, V] logit tensor is never made: each chunk
computes [B, chunk, V] float32 logits from the final hidden states, the
label log-prob and the log-partition. Padded vocab rows are masked
exactly. The reference scans over the chunks, and its autodiff keeps
every chunk's residuals; here, under autograd, each chunk runs under
`torch.utils.checkpoint` and is recomputed in the backward, so that only
one chunk's logits (1.05 GB for recurrentgemma-2b at B 2 x 512 tokens)
live at a time. The values are the same.

On a mesh (DTensors under `partitioning.mesh_context`) each chunk runs on
each rank's shards (`layers.on_shards`), at the reference's constraint
point, logits on ("batch", "seq", "vocab"). Where the policy shards the
vocabulary (``tp``: over "model"), a rank holds the logits of its slice
of the table; the log-partition combines the log-partitions of the ranks'
slices: the largest of them m (an all-reduce of max, held constant in
the gradient, as the log-partition's value does not depend on it) and
the sum of their exp(lse - m) (of sum). The gold logit is the sum of the
ranks' (each rank's zero where the label lies outside its slice). The
chunk's sums stay partial over the batch's mesh axes until the end, where
one all-reduce each makes the loss whole on every rank.

Off a mesh the same code runs with every mesh step the identity: m is the
chunk's `torch.logsumexp` and exp(lse - m) is exactly 1, so the log-partition
is logsumexp's in value and in gradient, bit for bit.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partitioning
from repro_torch.sharding.policy import Policy

IGNORE = -1          # label value that is excluded from the loss
NEG_INF = -1e30


def _vocab_offset(n_local: int, axis) -> int:
    """The first vocabulary row of this rank's slice of a table whose rows
    shard over the mesh axis `axis` (0 where none does): DTensor's even
    split, `n_local` rows a rank."""
    mesh = partitioning.current_mesh()
    if axis is None or mesh is None:
        return 0
    return mesh.get_local_rank(axis) * n_local


def _chunk_terms(cfg: ModelConfig, pol: Policy, h, w, lab):
    """(sum of nll, count of labels, sum of lse^2) of one chunk. On a mesh
    each is a DTensor partial over the batch's mesh axes (see the module's
    docstring); off a mesh `on_shards` and `constrain` are the identity
    and the vocabulary offset is 0."""
    from repro_torch.models.layers import Summed, on_shards

    axis = pol.rules.get("vocab")
    if isinstance(axis, tuple):
        raise NotImplementedError(f"a vocabulary sharded over {axis}")
    tok = ("batch", "seq")
    logit_axes = ("batch", "seq", "vocab")

    def logits_of(h, w):
        logits = (h @ w.T).float()
        off = _vocab_offset(w.shape[0], axis)
        vmask = off + torch.arange(w.shape[0], device=h.device) \
            < cfg.vocab_size
        logits = logits.masked_fill(~vmask, NEG_INF)
        if cfg.logit_softcap > 0:
            logits = torch.tanh(logits / cfg.logit_softcap) * \
                cfg.logit_softcap
        # the log-partition of this rank's slice: the ranks' largest is m
        return logits, torch.logsumexp(logits, -1).detach()

    def sums_of(logits, m, lab):
        off = _vocab_offset(logits.shape[-1], axis)
        e = torch.exp(torch.logsumexp(logits, -1) - m)
        safe = torch.clamp(lab, 0, cfg.vocab_size - 1).long() - off
        mine = (safe >= 0) & (safe < logits.shape[-1])
        gold = torch.gather(logits, -1,
                            torch.where(mine, safe, 0)[..., None])[..., 0]
        return e, torch.where(mine, gold, torch.zeros_like(gold))

    part = (lambda ax, op="sum": Summed(ax, axis, op)) if axis else \
        (lambda ax, op="sum": ax)
    logits, m = on_shards(logits_of, pol, (("batch", "seq", None),
                                           ("vocab", None)),
                          [logit_axes, part(tok, "max")], h, w)
    m = pol.constrain(m, *tok)
    e, gold = on_shards(sums_of, pol, (logit_axes, tok, tok),
                        [part(tok), part(tok)], logits, m, lab)
    lse = m + torch.log(pol.constrain(e, *tok))
    gold = pol.constrain(gold, *tok)
    valid = lab != IGNORE
    nll = torch.where(valid, lse - gold, torch.zeros_like(lse))
    z = torch.where(valid, lse ** 2, torch.zeros_like(lse))
    return nll.sum(), valid.sum(), z.sum()


def _whole(x):
    """A DTensor (a partial sum of the chunks) made whole on every rank;
    anything else as it is."""
    if not partitioning.is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return partitioning.redistribute(x, x.device_mesh,
                                     [Replicate()] * x.device_mesh.ndim)


def chunked_ce(cfg: ModelConfig, pol: Policy, hidden, embed_w, labels,
               chunk: int = 512, z_loss: float = 0.0):
    """hidden: [B, S, d]; embed_w: [Vpad, d]; labels: [B, S] (-1 = ignore).

    Returns (mean loss over non-ignored tokens, dict of scalars, detached
    from the graph).
    """
    B, S, d = hidden.shape
    if pol.rules.get("seq") is not None:
        chunk = S          # dp_seq: the reference's unchunked branch
    chunk = min(chunk, S)
    w = embed_w.to(hidden.dtype)
    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or w.requires_grad)
    terms = functools.partial(_chunk_terms, cfg, pol)
    sums = None
    for c0 in range(0, S, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if remat:
            got = checkpoint(terms, h, w, lab, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            got = terms(h, w, lab)
        # partial sums on a mesh add locally: no zero to start from, which
        # DTensor would have to split over the ranks
        sums = got if sums is None else [a + b for a, b in zip(sums, got)]
    tot, cnt, zacc = (_whole(x) for x in sums)
    denom = torch.clamp_min(cnt, 1).float()
    loss = tot / denom
    if z_loss > 0:
        loss = loss + z_loss * zacc / denom
    return loss, {"ce": (tot / denom).detach(), "tokens": cnt}
