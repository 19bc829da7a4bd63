"""Simulation dtype plumbing of the port.

The DES carries every time-integral accumulator in the workload dtype:
float32 by default, float64 on request. PyTorch needs no scoped flag for
float64, so only validation and the numpy<->torch dtype map remain of the
reference's `repro.core.precision`.
"""
from __future__ import annotations

import numpy as np
import torch

SUPPORTED_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def canonical_dtype(dtype) -> np.dtype:
    """Normalize a requested simulation dtype (numpy, torch or string) to
    a numpy dtype; raises ValueError for anything but float32/float64."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NP:
            raise ValueError(
                f"simulation dtype must be float32 or float64, got {dtype}")
        return _TORCH_TO_NP[dtype]
    d = np.dtype(dtype)
    if d not in SUPPORTED_DTYPES:
        raise ValueError(
            f"simulation dtype must be float32 or float64, got {d}")
    return d


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a simulation dtype given in any accepted form."""
    return _NP_TO_TORCH[canonical_dtype(dtype)]
