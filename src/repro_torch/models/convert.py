"""Parameters of the JAX package carried over to the port.

`params_from_jax(cfg, tree)` takes the reference's unboxed `init_params`
tree of any of its six families (`repro.models.lm` for dense, moe and vlm,
`xlstm`, `hybrid`, `encdec`) with its leaves as numpy arrays
(``np.asarray`` of each JAX array) and returns the port's parameter
dictionary: the stacked leaves under the family's ``STACKED_KEYS``
(``[L, ...]`` layers, an MoE layer's ``moe.{router, wi, wg, wo}`` among
them; ``[R, ...]`` xLSTM and hybrid pattern repeats; the encoder's and
decoder's ``[L, ...]`` layers) become one dictionary per layer or repeat,
every other subtree (the hybrid tail, the final norms) is carried as it
is, and the hybrid blocks' ``kind_*`` structural markers are dropped;
orientation ``[in, out]`` and dtypes are kept (the MoE router stays
float32 beside bf16 experts; bfloat16 arrives as numpy's ``bfloat16``
extension type and is rebuilt exactly). With ``device="meta"`` only the
leaves' ``shape`` and ``dtype`` are read (they may be the reference's
`jax.eval_shape` structs) and the tree is built of meta tensors: the
reference's parameter shapes under the port's names. Nothing here imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_family


def _meta(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), device=device,
                       dtype=getattr(torch, np.dtype(dtype).name))


def _tensor(x, device) -> torch.Tensor:
    if device.type == "meta":
        return _meta(x.shape, x.dtype, device)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # bf16 widens to float32 exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()
                if not k.startswith("kind_")}
    return fn(tree)


def _unstack(stacked, dev):
    """Leaves [n, ...] -> n trees of their [...] slices."""
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    if dev.type == "meta":      # one layer's shape: the leading axis off
        row = lambda x, i: _meta(tuple(x.shape)[1:], x.dtype, dev)
    else:
        row = lambda x, i: _tensor(np.asarray(x)[i], dev)
    return [_map(stacked, lambda x, i=i: row(x, i))
            for i in range(tuple(first.shape)[0])]


def params_from_jax(cfg: ModelConfig, tree, device=None):
    """The port's parameters from the reference's tree of `cfg`'s family.
    ``device=None`` means the card (raises without one)."""
    dev = resolve_device(device)
    stacked = get_family(cfg).STACKED_KEYS
    return {k: (_unstack(v, dev) if k in stacked else
                _map(v, lambda x: _tensor(x, dev)))
            for k, v in tree.items()}
