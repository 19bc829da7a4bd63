"""Parameters of the JAX package carried over to the port.

`params_from_jax(cfg, tree)` takes the reference's unboxed
`repro.models.lm.init_params` tree with its leaves as numpy arrays
(``np.asarray`` of each JAX array) and returns the port's parameter
dictionary: the layer-stacked leaves ``[L, ...]`` become one dictionary
per layer, orientation ``[in, out]`` and dtypes kept (bfloat16 arrives as
numpy's ``bfloat16`` extension type and is rebuilt exactly). Nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # bf16 widens to float32 exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg: ModelConfig, tree, device=None):
    """The port's parameters from the reference's dense-LM tree.
    ``device=None`` means the card (raises without one)."""
    dev = resolve_device(device)
    if cfg.n_experts:
        raise NotImplementedError("MoE parameters are not ported yet")
    stacked = tree["layers"]
    layers = [_map(stacked, lambda x, i=i: _tensor(np.asarray(x)[i], dev))
              for i in range(cfg.n_layers)]
    return {"embed": _tensor(tree["embed"], dev),
            "layers": layers,
            "norm": _map(tree["norm"], lambda x: _tensor(x, dev))}
