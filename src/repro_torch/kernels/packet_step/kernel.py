"""Build and ctypes binding of the CUDA event-step kernel.

The source is `repro_torch/csrc/packet_step.cu`: one templated kernel,
eight instantiations (float32/float64 x chaos off/on x the ring in shared
or in device memory), behind one plain C function `packet_step_launch`.
The library is built with `nvcc` at the first launch (see
`repro_torch.kernels.build`), never at import. A launch is T blocks of one
warp, one lane each; the lanes may belong to the W workloads of a cohort,
lane t reading the tables of member ``t // (T / W)``. `launch_plan` says
where the ring lives and how much shared memory a block takes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

from repro_torch.kernels import build

SOURCE = "packet_step"
FLAGS = build.NVCC_FLAGS
N_INPUTS = 16       # 9 read-only operands + 7 chaos operands (or null)
N_STATE_COLS = 23
N_LOGS = 4
N_DIMS = 10         # T, H, N, ring, r_cap, L_cap, cut_steps, log_offset,
                    # n_steps, W
N_PLAN = 2          # dynamic shared bytes, ring in shared memory
SMEM_OPTIN = 232_448      # dynamic shared bytes a block may opt into, sm_90


class LaunchPlan(NamedTuple):
    """`smem_bytes` of dynamic shared memory a block (one lane), and
    whether the ring lives there; `ring_in_smem` False selects the
    instantiation that scans the ring in device memory."""
    smem_bytes: int
    ring_in_smem: bool


def lane_smem_bytes(ring: int, H: int, is_f64: bool) -> int:
    """Shared bytes of one lane: its ring's `grp_end` [ring] of the float
    type, then its `head` and `tail` rows [H] of int32."""
    return ring * (8 if is_f64 else 4) + 2 * H * 4


def launch_plan(H: int, ring: int, is_f64: bool) -> LaunchPlan:
    """The plan for lanes of H types and a ring of `ring` slots. Never
    refuses a shape: the device-memory ring where one lane's columns exceed
    the shared-memory opt-in."""
    if min(H, ring) < 1:
        raise ValueError(f"H and ring must be >= 1, got {H}, {ring}")
    per_lane = lane_smem_bytes(ring, H, is_f64)
    if per_lane <= SMEM_OPTIN:
        return LaunchPlan(smem_bytes=per_lane, ring_in_smem=True)
    return LaunchPlan(smem_bytes=0, ring_in_smem=False)

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
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(is_f64: bool, has_chaos: bool, inputs, state, logs, dims,
           plan: LaunchPlan, stream: int) -> int:
    """Enqueue one launch on `stream`. `inputs`, `state` and `logs` are
    sequences of device pointers (Python ints, 0 for an absent chaos
    operand), `dims` the ten integers the C function documents, `plan`
    from `launch_plan`. Returns the launch's `cudaGetLastError()`."""
    if (len(inputs), len(state), len(logs), len(dims)) != (
            N_INPUTS, N_STATE_COLS, N_LOGS, N_DIMS):
        raise ValueError("packet_step launch: wrong operand count")
    lib = load()
    in_arr = (ctypes.c_void_p * N_INPUTS)(*inputs)
    st_arr = (ctypes.c_void_p * N_STATE_COLS)(*state)
    log_arr = (ctypes.c_void_p * N_LOGS)(*logs)
    dim_arr = (ctypes.c_int * N_DIMS)(*dims)
    plan_arr = (ctypes.c_int * N_PLAN)(plan.smem_bytes,
                                       int(plan.ring_in_smem))
    return int(lib.packet_step_launch(
        int(bool(is_f64)), int(bool(has_chaos)), in_arr, st_arr, log_arr,
        dim_arr, plan_arr, ctypes.c_void_p(stream)))
