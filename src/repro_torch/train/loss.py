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
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import Policy

IGNORE = -1          # label value that is excluded from the loss
NEG_INF = -1e30


def _chunk_terms(cfg: ModelConfig, h, w, lab):
    """(sum of nll, count of labels, sum of lse^2) of one chunk."""
    logits = (h @ w.T).float()
    vmask = torch.arange(w.shape[0], device=h.device) < cfg.vocab_size
    logits = logits.masked_fill(~vmask, NEG_INF)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp(lab, 0, cfg.vocab_size - 1).long()
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    valid = lab != IGNORE
    zero = torch.zeros((), dtype=lse.dtype, device=lse.device)
    nll = torch.where(valid, lse - gold, zero)
    z = torch.where(valid, lse ** 2, zero)
    return nll.sum(), valid.sum(), z.sum()


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
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    zacc = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if remat:
            nll, n, z = checkpoint(_chunk_terms, cfg, h, w, lab,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            nll, n, z = _chunk_terms(cfg, h, w, lab)
        tot, cnt, zacc = tot + nll, cnt + n, zacc + z
    denom = torch.clamp_min(cnt, 1).float()
    loss = tot / denom
    if z_loss > 0:
        loss = loss + z_loss * zacc / denom
    return loss, {"ce": (tot / denom).detach(), "tokens": cnt}
