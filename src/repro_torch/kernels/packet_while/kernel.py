"""Build and ctypes binding of the CUDA while-loop engine kernel.

The source is `repro_torch/csrc/packet_while.cu`: one templated kernel,
eight instantiations (float32/float64 x chaos off/on x the lane's columns
in shared or in device memory), behind one plain C function
`packet_while_launch`. The library is built with `nvcc` at the first
launch (see `repro_torch.kernels.build`), never at import, with
``-fmad=false`` like the other DES kernels. A launch is T blocks of one
warp, one lane each, that run their lanes' loops to the end; `launch_plan`
says where a lane's per-type and ring columns live and how much shared
memory a block takes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

from repro_torch.kernels import build

SOURCE = "packet_while"
FLAGS = build.NVCC_FLAGS
N_INPUTS = 16       # 9 read-only operands + 7 chaos operands (or null)
N_STATE_COLS = 28   # the DesState columns
N_DIMS = 9          # T, H, N, ring, L, M, r_cap, max_iters, cut_steps
N_PLAN = 2          # dynamic shared bytes, columns in shared memory
SMEM_OPTIN = 232_448      # dynamic shared bytes a block may opt into, sm_90


class LaunchPlan(NamedTuple):
    """`smem_bytes` of dynamic shared memory a block (one lane), and
    whether the lane's columns live there; `ring_in_smem` False selects
    the instantiation that works on them in device memory."""
    smem_bytes: int
    ring_in_smem: bool


def lane_smem_bytes(ring: int, H: int, is_f64: bool, chaos: bool) -> int:
    """Shared bytes of one lane. The float columns first: `grp_end`
    [ring], and under chaos `grp_rem_w`, `grp_rem_oldest` [ring] and
    `pool_w`, `pool_oldest` [H]; then the int32 columns: `grp_m` [ring],
    `head`, `tail` [H], and under chaos `grp_jtype`, `grp_rem_cnt` [ring]
    and `pool_code` [H]."""
    f = 8 if is_f64 else 4
    n_float = ring + (2 * ring + 2 * H if chaos else 0)
    n_int = ring + 2 * H + (2 * ring + H if chaos else 0)
    return n_float * f + n_int * 4


def launch_plan(H: int, ring: int, is_f64: bool, chaos: bool) -> LaunchPlan:
    """The plan for lanes of H types and a ring of `ring` slots. Never
    refuses a shape: the columns stay in device memory where one lane's
    exceed the shared-memory opt-in."""
    if min(H, ring) < 1:
        raise ValueError(f"H and ring must be >= 1, got {H}, {ring}")
    per_lane = lane_smem_bytes(ring, H, is_f64, chaos)
    if per_lane <= SMEM_OPTIN:
        return LaunchPlan(smem_bytes=per_lane, ring_in_smem=True)
    return LaunchPlan(smem_bytes=0, ring_in_smem=False)


_lib = None


def load() -> ctypes.CDLL:
    """The built library with `packet_while_launch` typed; builds it on the
    first call."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, FLAGS)
        fn = lib.packet_while_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(is_f64: bool, has_chaos: bool, inputs, state, dims,
           plan: LaunchPlan, stream: int) -> int:
    """Enqueue one launch on `stream`. `inputs` and `state` are sequences
    of device pointers (Python ints, 0 for an absent chaos operand), `dims`
    the nine integers the C function documents, `plan` from
    `launch_plan`. Returns the launch's `cudaGetLastError()`."""
    if (len(inputs), len(state), len(dims)) != (N_INPUTS, N_STATE_COLS,
                                                N_DIMS):
        raise ValueError("packet_while launch: wrong operand count")
    lib = load()
    in_arr = (ctypes.c_void_p * N_INPUTS)(*inputs)
    st_arr = (ctypes.c_void_p * N_STATE_COLS)(*state)
    dim_arr = (ctypes.c_int * N_DIMS)(*dims)
    plan_arr = (ctypes.c_int * N_PLAN)(plan.smem_bytes,
                                       int(plan.ring_in_smem))
    return int(lib.packet_while_launch(
        int(bool(is_f64)), int(bool(has_chaos)), in_arr, st_arr, dim_arr,
        plan_arr, ctypes.c_void_p(stream)))
