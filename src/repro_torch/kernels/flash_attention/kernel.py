"""Build and ctypes binding of the CUDA flash-attention kernels.

The source is `repro_torch/csrc/flash_attention.cu` (with the Hopper
helpers of `csrc/hopper.cuh`): two kernels, chosen by the inputs' type,
each instantiated for head dims 16, 32, 64, 128 and 256, behind one plain C
function `flash_attention_launch`:

- bfloat16: the Hopper kernel, `wgmma` tensor-core products fed by a TMA
  ring; its probabilities enter the P.V product as two bf16 terms
  (hi + lo, about 2^-16 of p);
- float32: the CUDA-core kernel, float32 throughout.

That is a dispatch by type (`KIND`), not a fallback: any other type raises
before anything is built, and a failed launch of either kernel raises. The
library is built with `nvcc` at the first launch (see
`repro_torch.kernels.build`), never at import. Unlike the event-step kernel
it is compiled with fused multiply-adds allowed: its contract with the
plain version is a stated tolerance, not bitwise equality.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention"
FLAGS = tuple(f for f in build.NVCC_FLAGS if f != "-fmad=false")
HEAD_DIMS = (16, 32, 64, 128, 256)
# the C function's `kind` for each input type
KIND = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def load() -> ctypes.CDLL:
    """The built library with its two C functions typed; builds it on the
    first call."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, FLAGS)
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int,
                                                   ctypes.c_int]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def kind(dtype: torch.dtype) -> int:
    """The kernel for inputs of `dtype`: 0 (float32, CUDA cores) or 1
    (bfloat16, Hopper tensor cores). Raises ValueError for any other
    type."""
    if dtype not in KIND:
        raise ValueError(f"flash_attention launch: no kernel for {dtype}; "
                         f"have {tuple(KIND)}")
    return KIND[dtype]


def _check_head_dim(hd: int):
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention launch: no instantiation for "
                         f"head dim {hd}; have {HEAD_DIMS}")


def launch(dtype: torch.dtype, hd: int, q: int, k: int, v: int, o: int,
           dims, causal: bool, window: int, softcap: float, scale: float,
           stream: int) -> int:
    """Enqueue one launch on `stream`. `q`, `k`, `v`, `o` are device
    pointers (Python ints), `dims` the five integers ``(B, Sq, Skv, H,
    KV)``. Returns the C function's code: 0 when the launch was accepted,
    else a CUDA error, -2 (the CUDA driver has no `cuTensorMapEncodeTiled`)
    or -1000 - the CUDA driver's code for a tensor map it refused."""
    which = kind(dtype)
    _check_head_dim(hd)
    B, Sq, Skv, H, KV = (int(d) for d in dims)
    return int(load().flash_attention_launch(
        which, int(hd), ctypes.c_void_p(q), ctypes.c_void_p(k),
        ctypes.c_void_p(v), ctypes.c_void_p(o), B, Sq, Skv, H, KV,
        int(bool(causal)), int(window), float(softcap), float(scale),
        ctypes.c_void_p(stream)))


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory of one block of the kernel for (`dtype`,
    `hd`); builds the library on the first call."""
    which = kind(dtype)
    _check_head_dim(hd)
    return int(load().flash_attention_smem_bytes(which, int(hd)))
