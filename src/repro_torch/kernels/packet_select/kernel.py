"""Build and ctypes binding of the CUDA group-formation decision kernel.

The source is `repro_torch/csrc/packet_select.cu`: one templated kernel,
two instantiations (float32, float64), behind one plain C function
`packet_select_launch`. The library is built with `nvcc` at the first
launch (see `repro_torch.kernels.build`), never at import, with
``-fmad=false`` like the event-step kernel so that every operation rounds
as PyTorch's elementwise ops do.
"""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "packet_select"
FLAGS = build.NVCC_FLAGS
N_INPUTS = 9        # sum_w, s_j, p_j, oldest, t_max, nonempty, now, k, m_free
N_OUTPUTS = 4       # j, m, dur, work
BLOCK = 128         # one row a thread

_lib = None


def load() -> ctypes.CDLL:
    """The built library with `packet_select_launch` typed; builds it on the
    first call."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, FLAGS)
        fn = lib.packet_select_launch
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(is_f64: bool, inputs, outputs, T: int, H: int,
           stream: int) -> int:
    """Enqueue one launch on `stream`. `inputs` and `outputs` are sequences
    of device pointers (Python ints) in the order the C function documents.
    Returns the launch's `cudaGetLastError()` (-1 for refused sizes)."""
    if (len(inputs), len(outputs)) != (N_INPUTS, N_OUTPUTS):
        raise ValueError("packet_select launch: wrong operand count")
    lib = load()
    in_arr = (ctypes.c_void_p * N_INPUTS)(*inputs)
    out_arr = (ctypes.c_void_p * N_OUTPUTS)(*outputs)
    return int(lib.packet_select_launch(
        int(bool(is_f64)), in_arr, out_arr, int(T), int(H), BLOCK,
        ctypes.c_void_p(stream)))
