"""Batched serving engine: prefill or prompt replay, then greedy decode.

The counterpart of the reference's `repro/serve/engine.py`
(`engine.py:35-83`). ``serve_step`` is one new token for every sequence of
the batch against the family's decode state, ``make_decode_logits_step``
the same step with the logits out. ``generate`` takes one of
three branches, as the reference does:

  * dense, moe and vlm (`models/lm.py`): prefill the prompt (which seeds
    the KV cache; a VLM backbone's first ``embeds.shape[1]`` positions
    take `embeds`), take the last position's argmax, then run
    ``max_new - 1`` decode steps; it returns the ``max_new`` generated
    tokens;
  * encdec (`models/encdec.py`): encode `embeds` (the frames of the
    stubbed frontend), compute every decoder layer's cross K/V of the
    memory once (their length is the memory's, whatever ``MEMORY_LEN``
    says, as the reference replaces the cache's), then replay the
    prompt teacher-forced and decode as below;
  * ssm and hybrid (recurrent, `models/xlstm.py`, `models/hybrid.py`):
    from the family's `init_cache`.

The last two replay the prompt's first ``S - 1`` tokens one decode step
each, then decode ``max_new - 1`` steps starting from the prompt's last
token; they return that last prompt token as their first column, followed
by the ``max_new - 1`` generated tokens (the reference's output, kept as
it is). A recurrent family does not read `embeds`, as the reference does
not read it there.

Greedy ties go to the first index, as `torch.argmax` and `jnp.argmax`
both resolve them.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import encdec, lm
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


def make_decode_logits_step(cfg: ModelConfig, pol: Policy):
    """The raw decode step, logits out: (params, cache, tokens [B,1]) ->
    (logits [B,1,V], cache). What a decode cell of the dry run builds
    (`launch/dryrun.py`)."""
    family = get_family(cfg)

    def step(params, cache, tokens):
        return family.decode_step(cfg, pol, params, cache, tokens)

    return step


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.inference_mode()
def generate(cfg: ModelConfig, pol: Policy, params, prompts,
             max_new: int = 16, max_len: Optional[int] = None,
             embeds=None, stats: Optional[dict] = None) -> np.ndarray:
    """Greedy generation. prompts: [B, S] integer tokens (numpy or a
    tensor); `embeds`: [B, n, d] frontend embeddings of a VLM backbone's
    first n positions, the encoder's n frames of an encoder-decoder (which
    needs them), or None; runs where the parameters live. Returns
    [B, max_new] int32.

    When `stats` is a dict it receives ``decode_seconds`` and, for the
    families of `models/lm.py`, ``prefill_seconds`` and ``prefill_logits``
    (the last prompt position's logits [B, 1, padded vocab]), for the
    others ``replay_seconds``, and for encdec ``encode_seconds`` (the
    encoder and the cross K/V; its replay_seconds begin after them). Host
    clock, each stage ended by a device synchronize."""
    family = get_family(cfg)
    step = make_serve_step(cfg, pol)
    device = params["embed"].device
    prompts = torch.as_tensor(prompts, device=device).long()
    B, S = prompts.shape
    max_len = max_len or (S + max_new)

    t0 = _clock(device) if stats is not None else 0.0
    if cfg.family in lm.LM_FAMILIES:
        if embeds is not None:
            embeds = torch.as_tensor(embeds, device=device)
        hidden, cache = lm.prefill(cfg, pol, params, prompts, max_len,
                                   embeds=embeds)
        logits = unembed(cfg, pol, hidden[:, -1:], params["embed"])
        tok = torch.argmax(logits, dim=-1)
        if stats is not None:
            stats.update(prefill_seconds=_clock(device) - t0,
                         prefill_logits=logits)
    else:
        if cfg.family == "encdec":
            if embeds is None:
                raise ValueError("encdec needs frontend frames (embeds=...)")
            memory = encdec.encode(cfg, pol, params,
                                   torch.as_tensor(embeds, device=device))
            xk, xv = encdec.prefill_cross_kv(cfg, pol, params, memory)
            cache = encdec.init_cache(cfg, pol, B, max_len, memory_len=0,
                                      device=device)._replace(xk=xk, xv=xv)
            if stats is not None:
                stats.update(encode_seconds=_clock(device) - t0)
                t0 = _clock(device)
        else:
            cache = family.init_cache(cfg, pol, B, max_len, device=device)
        # replay the prompt token by token (teacher-forced for encdec)
        for i in range(S - 1):
            _, cache = family.decode_step(cfg, pol, params, cache,
                                          prompts[:, i:i + 1])
        tok = prompts[:, -1:]
        if stats is not None:
            stats.update(replay_seconds=_clock(device) - t0)
    t1 = _clock(device) if stats is not None else 0.0

    out = [tok]
    for _ in range(max_new - 1):
        tok, cache = step(params, cache, tok)
        out.append(tok)
    tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
    if stats is not None:
        stats.update(decode_seconds=_clock(device) - t1)
    return tokens
