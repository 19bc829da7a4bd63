"""`get_family`: the model API of a config's family, as in the reference.

The port has four of the reference's families, each served by a module
that is its API:
  init_params(cfg, pol, gen)              -> parameter dict on gen's device
  forward(cfg, pol, params, tokens, embeds=None) -> (hidden [B,S,d], aux)
  init_cache(cfg, pol, batch, max_len)    -> decode state
  decode_step(cfg, pol, params, cache, tokens) -> (logits [B,1,V], cache)
the decoder-only LM (`models/lm.py`) for the dense, moe and vlm families,
as the reference's `FAMILIES` maps them, and the hybrid RG-LRU +
local-attention LM (`models/hybrid.py`). The xLSTM and encoder-decoder
families raise `NotImplementedError` naming their ROADMAP.md item
(`lm.check_ported`). The reference's `cache_axes` (logical sharding axes
of the cache) has no counterpart on one card.
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.models import hybrid, lm
from repro_torch.models.config import ModelConfig


def get_family(cfg: ModelConfig) -> ModuleType:
    lm.check_ported(cfg)
    return hybrid if cfg.family == "hybrid" else lm
