"""Build and ctypes binding of the CUDA baseline-schedulers kernel.

The source is `repro_torch/csrc/baselines.cu`: one templated kernel, four
instantiations (float32/float64 x FCFS/EASY backfill), behind one plain C
function `baselines_launch`. The library is built with `nvcc` at the first
launch (see `repro_torch.kernels.build`), never at import, with
``-fmad=false`` like the other DES kernels. A launch is T blocks of one
warp, one lane each, that run their lanes' event loops to the end;
`launch_plan` says how many bytes a lane's ring, sorted running list,
candidates and started set take and whether they fit in shared memory.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

from repro_torch.kernels import build

SOURCE = "baselines"
FLAGS = build.NVCC_FLAGS
N_INPUTS = 5        # submit, runtime, nodes, t_last, s
N_OUTPUTS = 9       # the BaselineOut fields
N_DIMS = 6          # T, N, ring, depth, M, max_iters
N_PLAN = 3          # lane bytes, lane in shared memory, started words
SMEM_OPTIN = 232_448      # dynamic shared bytes a block may opt into, sm_90


class LaunchPlan(NamedTuple):
    """`lane_bytes` of one lane's working columns, and whether they live
    in dynamic shared memory (else in a device-memory workspace of
    ``[T, lane_bytes]``); `started_words`, the 32-bit words of the lane's
    started set (0 for FCFS, which starts jobs in submit order)."""
    lane_bytes: int
    lane_in_smem: bool
    started_words: int


def lane_bytes(n_jobs: int, ring: int, depth: int, is_f64: bool,
               backfill: bool) -> int:
    """Bytes of one lane: `grp_end` and the sorted ends [ring] of the
    float type, `grp_m` and the sorted slots [ring] of int32, then, for
    backfill, the candidates [depth] of int32 and the started set, one bit
    a job. Each part starts at a multiple of 8 bytes."""
    f = 8 if is_f64 else 4
    up8 = lambda b: -(-b // 8) * 8
    total = 2 * up8(ring * f) + 2 * up8(ring * 4)
    if backfill:
        total += up8(depth * 4) + up8(4 * -(-n_jobs // 32))
    return total


def launch_plan(n_jobs: int, ring: int, depth: int, is_f64: bool,
                backfill: bool) -> LaunchPlan:
    """The plan for lanes of `n_jobs` jobs and `ring` slots. Never refuses
    a shape: the columns live in a device-memory workspace where one
    lane's exceed the shared-memory opt-in."""
    if min(n_jobs, ring) < 1 or depth < 0:
        raise ValueError(f"n_jobs and ring must be >= 1 and depth >= 0, "
                         f"got {n_jobs}, {ring}, {depth}")
    nbytes = lane_bytes(n_jobs, ring, depth, is_f64, backfill)
    words = -(-n_jobs // 32) if backfill else 0
    return LaunchPlan(lane_bytes=nbytes, lane_in_smem=nbytes <= SMEM_OPTIN,
                      started_words=words)


_lib = None


def load() -> ctypes.CDLL:
    """The built library with `baselines_launch` typed; builds it on the
    first call."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, FLAGS)
        fn = lib.baselines_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(is_f64: bool, backfill: bool, inputs, outputs, workspace: int,
           dims, plan: LaunchPlan, stream: int) -> int:
    """Enqueue one launch on `stream`. `inputs` and `outputs` are sequences
    of device pointers (Python ints), `workspace` the device pointer of the
    ``[T, lane_bytes]`` workspace (0 when the plan puts the lane in shared
    memory), `dims` the six integers the C function documents, `plan`
    from `launch_plan`. Returns the launch's `cudaGetLastError()`."""
    if (len(inputs), len(outputs), len(dims)) != (N_INPUTS, N_OUTPUTS,
                                                  N_DIMS):
        raise ValueError("baselines launch: wrong operand count")
    lib = load()
    in_arr = (ctypes.c_void_p * N_INPUTS)(*inputs)
    out_arr = (ctypes.c_void_p * N_OUTPUTS)(*outputs)
    dim_arr = (ctypes.c_int * N_DIMS)(*dims)
    plan_arr = (ctypes.c_int * N_PLAN)(plan.lane_bytes,
                                       int(plan.lane_in_smem),
                                       plan.started_words)
    return int(lib.baselines_launch(
        int(bool(is_f64)), int(bool(backfill)), in_arr, out_arr,
        ctypes.c_void_p(workspace), dim_arr, plan_arr,
        ctypes.c_void_p(stream)))
