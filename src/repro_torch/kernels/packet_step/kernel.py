"""Build and ctypes binding of the CUDA event-step kernel.

The source is `repro_torch/csrc/packet_step.cu`: one templated kernel,
four instantiations (float32/float64 x chaos off/on), behind one plain C
function `packet_step_launch`. The library is built with `nvcc` at the
first launch (see `repro_torch.kernels.build`), never at import.
"""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "packet_step"
FLAGS = build.NVCC_FLAGS
N_INPUTS = 16       # 9 read-only operands + 7 chaos operands (or null)
N_STATE_COLS = 23
N_LOGS = 4
N_DIMS = 9          # T, H, N, ring, r_cap, L_cap, cut_steps, log_offset, n_steps
BLOCK = 32          # one warp per block: the warps spread over separate SMs

_lib = None


def load() -> ctypes.CDLL:
    """The built library with `packet_step_launch` typed; builds it on the
    first call."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, FLAGS)
        fn = lib.packet_step_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(is_f64: bool, has_chaos: bool, inputs, state, logs, dims,
           stream: int) -> int:
    """Enqueue one launch on `stream`. `inputs`, `state` and `logs` are
    sequences of device pointers (Python ints, 0 for an absent chaos
    operand), `dims` the nine integers the C function documents. Returns
    the launch's `cudaGetLastError()`."""
    if (len(inputs), len(state), len(logs), len(dims)) != (
            N_INPUTS, N_STATE_COLS, N_LOGS, N_DIMS):
        raise ValueError("packet_step launch: wrong operand count")
    lib = load()
    in_arr = (ctypes.c_void_p * N_INPUTS)(*inputs)
    st_arr = (ctypes.c_void_p * N_STATE_COLS)(*state)
    log_arr = (ctypes.c_void_p * N_LOGS)(*logs)
    dim_arr = (ctypes.c_int * N_DIMS)(*dims)
    return int(lib.packet_step_launch(
        int(bool(is_f64)), int(bool(has_chaos)), in_arr, st_arr, log_arr,
        dim_arr, BLOCK, ctypes.c_void_p(stream)))
