"""`get_family`: the model API of a config's family, as in the reference.

The port has all six of the reference's families (its
`registry.FAMILIES`), each served by a module that is its API:
  init_params(cfg, pol, gen)              -> parameter dict on gen's device
  forward(cfg, pol, params, tokens, embeds=None) -> (hidden [B,S,d], aux)
  init_cache(cfg, pol, batch, max_len)    -> decode state
  decode_step(cfg, pol, params, cache, tokens) -> (logits [B,1,V], cache)
  param_axes(cfg, pol)                    -> logical axes of init_params'
                                             leaves (the reference's
                                             `unbox(...)[1]`, one dict a
                                             layer, no leading "layers")
  cache_axes(cfg)                         -> logical axes of init_cache's
                                             tensors (the reference's, its
                                             leading "layers" kept: the
                                             caches stack the layers)
the decoder-only LM (`models/lm.py`) for the dense, moe and vlm families,
the xLSTM LM (`models/xlstm.py`) for ssm, the hybrid RG-LRU +
local-attention LM (`models/hybrid.py`) and the encoder-decoder backbone
(`models/encdec.py`). An unknown family raises `ValueError`. On a mesh
(`launch/dryrun.py --run --mesh`) a prefill or decode cell runs sharded,
the cache on its `cache_axes`, and so does a train cell of the dense,
encoder-decoder and VLM families under ``tp``, ``dp_zero1`` or
``dp_zero3``, and of the MoE family under ``tp``; ``dp_seq``, the MoE
family under ``dp_zero1`` / ``dp_zero3`` and the hybrid and xLSTM
families' train steps wait for ROADMAP.md item 19b, step 3b.
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.models import encdec, hybrid, lm, xlstm
from repro_torch.models.config import ModelConfig

FAMILIES: dict[str, ModuleType] = {
    "dense": lm, "moe": lm, "vlm": lm,
    "ssm": xlstm, "hybrid": hybrid, "encdec": encdec,
}


def get_family(cfg: ModelConfig) -> ModuleType:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return FAMILIES[cfg.family]
