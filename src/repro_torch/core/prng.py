"""Threefry-2x32 and the uniform draw of `jax.random`, in plain PyTorch.

The DES's fault injection (chaos) consumes one uniform stream per lane,
``uniform(fold_in(PRNGKey(seed), lane), (cap, 2))``, and the reference
draws it with `jax.random` (threefry2x32, in its partitionable counter
layout). This module gives the same bits on any torch device, so a lane's
faults do not depend on where, or in which layout, it runs.

Words are carried as ``int64`` tensors holding unsigned 32-bit values and
masked to 32 bits after every add and rotate: PyTorch's ``uint32`` has few
operations, and this form runs alike on the CPU and on CUDA. A key is an
``int64`` tensor of shape ``[..., 2]``; leading axes are lanes.

What is reproduced, with its source in `jax._src`:

* `PRNGKey` — ``prng.threefry_seed``: the seed's high and low 32 bits. JAX
  without 64-bit mode first narrows a Python int to int32, which zeroes
  the high word; ``x64=True`` keeps it (the reference draws its float64
  streams under its 64-bit scope).
* `fold_in` — ``prng._threefry_fold_in``: the key hashed with the counter
  pair ``(0, data)``.
* `uniform` — ``random._uniform`` over
  ``prng._threefry_random_bits_partitionable``: element i of the flat
  shape hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)``; float32
  takes the XOR of the two output words, float64 the two words as one
  64-bit integer (high word first). The top mantissa bits, or-ed with the
  bits of 1.0, make a float in [1, 2), and 1.0 is subtracted.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000
_ONE_F64_BITS = 0x3FF0000000000000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``; all four broadcast against each other and
    hold values in [0, 2**32) as int64. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed: int, x64: bool = False, device=None) -> torch.Tensor:
    """The raw key ``[2]`` of ``jax.random.PRNGKey(seed)``: JAX's default
    (32-bit) mode with ``x64=False``, its 64-bit mode with ``x64=True``.
    The two differ only for seeds outside [0, 2**32)."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise ValueError(f"a PRNG seed must fit in int64, got {seed}")
    hi = (seed >> 32) & MASK32 if x64 else 0
    return torch.tensor([hi, seed & MASK32], dtype=torch.int64,
                        device=device)


def _words(data, device) -> torch.Tensor:
    """Integers as uint32 words (modulo 2**32, as a conversion to uint32
    does) in an int64 tensor on `device`."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64) & MASK32
    arr = np.asarray(data).astype(np.int64) & MASK32
    return torch.tensor(arr, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for every element of `data` (a
    scalar or an array of lane ids): returns keys of shape
    ``data.shape + [2]``."""
    d = _words(data, key.device)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack((o1, o2), dim=-1)


def random_bits(key: torch.Tensor, shape) -> tuple:
    """The two output words of the partitionable counter layout for every
    element of `shape`, under each key of `key` (``[..., 2]``): tensors of
    shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return b1.reshape(lead + shape), b2.reshape(lead + shape)


def uniform(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1), bit for bit,
    for float32 and float64, under each key of `key` (``[..., 2]``):
    returns ``key.shape[:-1] + shape``."""
    b1, b2 = random_bits(key, shape)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | _ONE_F32_BITS
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        bits = (b1 << 20) | (b2 >> 12) | _ONE_F64_BITS
        return bits.view(torch.float64) - 1.0
    raise ValueError(f"uniform draws float32 or float64, got {dtype}")
