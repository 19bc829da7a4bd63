"""Build and ctypes binding of the CUDA flash-attention kernel.

The source is `repro_torch/csrc/flash_attention.cu`: one templated kernel,
ten instantiations (head dim 16, 32, 64, 128, 256 x float32 / bfloat16),
behind one plain C function `flash_attention_launch`. The library is built
with `nvcc` at the first launch (see `repro_torch.kernels.build`), never
at import. Unlike the event-step kernel it is compiled with fused
multiply-adds allowed: its contract with the plain version is a stated
tolerance, not bitwise equality.
"""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "flash_attention"
FLAGS = tuple(f for f in build.NVCC_FLAGS if f != "-fmad=false")
HEAD_DIMS = (16, 32, 64, 128, 256)

_lib = None


def load() -> ctypes.CDLL:
    """The built library with `flash_attention_launch` typed; builds it on
    the first call."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, FLAGS)
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(is_bf16: bool, hd: int, q: int, k: int, v: int, o: int,
           dims, causal: bool, window: int, softcap: float, scale: float,
           stream: int) -> int:
    """Enqueue one launch on `stream`. `q`, `k`, `v`, `o` are device
    pointers (Python ints), `dims` the five integers ``(B, Sq, Skv, H,
    KV)``. Returns the launch's `cudaGetLastError()`."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention launch: no instantiation for "
                         f"head dim {hd}; have {HEAD_DIMS}")
    B, Sq, Skv, H, KV = (int(d) for d in dims)
    return int(load().flash_attention_launch(
        int(bool(is_bf16)), int(hd), ctypes.c_void_p(q), ctypes.c_void_p(k),
        ctypes.c_void_p(v), ctypes.c_void_p(o), B, Sq, Skv, H, KV,
        int(bool(causal)), int(window), float(softcap), float(scale),
        ctypes.c_void_p(stream)))
