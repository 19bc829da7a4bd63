"""Build and ctypes binding of the CUDA RG-LRU recurrence kernel.

The source is `repro_torch/csrc/rglru_scan.cu`: one templated kernel,
four instantiations (float32 or bfloat16 x forward or reverse, the
reverse with ``dlog_a`` fused in), behind one plain C function
`rglru_scan_launch`. The library is built with `nvcc` at the first launch
(see `repro_torch.kernels.build`), never at import. Fused multiply-adds
are allowed: its contract with the plain version is a stated tolerance.
"""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "rglru_scan"
FLAGS = tuple(f for f in build.NVCC_FLAGS if f != "-fmad=false")

_lib = None


def load() -> ctypes.CDLL:
    """The built library with `rglru_scan_launch` typed; builds it on the
    first call."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, FLAGS)
        fn = lib.rglru_scan_launch
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(bf16: bool, reverse: bool, log_a: int, x: int, c0: int, h0: int,
           h_fwd: int, h: int, dlog_a: int, h_last: int, dims,
           stream: int) -> int:
    """Enqueue one launch on `stream`. The pointers are device addresses
    (Python ints, 0 for an absent operand) of tensors that are all
    bfloat16 (`bf16`) or all float32, `dims` the three integers
    ``(B, S, D)``; the C function documents the operands of each direction.
    Returns the launch's `cudaGetLastError()` (-1 for refused dims or a
    missing operand)."""
    B, S, D = (int(d) for d in dims)
    ptr = ctypes.c_void_p
    return int(load().rglru_scan_launch(
        int(bool(bf16)), int(bool(reverse)),
        ptr(log_a), ptr(x), ptr(c0), ptr(h0), ptr(h_fwd), ptr(h),
        ptr(dlog_a), ptr(h_last), B, S, D, ptr(stream)))
