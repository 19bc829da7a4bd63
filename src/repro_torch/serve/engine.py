"""Batched serving engine: prefill + greedy decode, dense family.

The counterpart of the reference's `repro/serve/engine.py` (dense branch,
`engine.py:45-83`). ``serve_step`` is one new token for every sequence of
the batch against the family's decode state; ``generate`` prefills the
prompt (which seeds the KV cache), takes the last position's argmax, then
runs ``max_new - 1`` decode steps. Greedy ties go to the first index, as
`torch.argmax` and `jnp.argmax` both resolve them. The reference replays a
recurrent family's prompt token by token from the family's `init_cache`;
the hybrid family's raises, as its serving is not ported yet.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import unembed
from repro_torch.models.registry import get_family
from repro_torch.sharding.policy import Policy


def make_serve_step(cfg: ModelConfig, pol: Policy):
    """(params, cache, tokens [B,1]) -> (next_tokens [B,1], cache)."""
    family = get_family(cfg)

    def serve_step(params, cache, tokens):
        logits, cache = family.decode_step(cfg, pol, params, cache, tokens)
        return torch.argmax(logits[:, -1:], dim=-1), cache

    return serve_step


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.inference_mode()
def generate(cfg: ModelConfig, pol: Policy, params, prompts,
             max_new: int = 16, max_len: Optional[int] = None,
             stats: Optional[dict] = None) -> np.ndarray:
    """Greedy generation. prompts: [B, S] integer tokens (numpy or a
    tensor); runs where the parameters live. Returns [B, max_new] int32.

    When `stats` is a dict it receives ``prefill_seconds`` and
    ``decode_seconds`` (host clock, each ended by a device synchronize)
    and ``prefill_logits``, the last prompt position's logits
    [B, 1, padded vocab]."""
    step = make_serve_step(cfg, pol)        # raises for unported families
    device = params["embed"].device
    prompts = torch.as_tensor(prompts, device=device).long()
    B, S = prompts.shape
    max_len = max_len or (S + max_new)
    if cfg.family != "dense":
        # the reference replays the prompt token by token from the family's
        # `init_cache`; the hybrid family's raises (not ported yet)
        get_family(cfg).init_cache(cfg, pol, B, max_len)

    t0 = _clock(device) if stats is not None else 0.0
    hidden, cache = lm.prefill(cfg, pol, params, prompts, max_len)
    logits = unembed(cfg, pol, hidden[:, -1:], params["embed"])
    tok = torch.argmax(logits, dim=-1)
    if stats is not None:
        t1 = _clock(device)
        stats.update(prefill_seconds=t1 - t0, prefill_logits=logits)

    out = [tok]
    for _ in range(max_new - 1):
        tok, cache = step(params, cache, tok)
        out.append(tok)
    tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
    if stats is not None:
        stats.update(decode_seconds=_clock(device) - t1)
    return tokens
