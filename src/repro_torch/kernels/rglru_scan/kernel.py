"""Build, ctypes binding and launch plan of the CUDA RG-LRU recurrence
kernel.

The source is `repro_torch/csrc/rglru_scan.cu`: one templated kernel,
four instantiations (float32 or bfloat16 x forward or reverse), behind one
plain C function `rglru_scan_launch`. The library is built with `nvcc` at
the first launch (see `repro_torch.kernels.build`), never at import.
Fused multiply-adds are allowed: its contract with the plain version is a
stated tolerance.

What bounds the kernel is bytes, and what it needs is enough of them in
flight, which one thread walking each (b, d) cannot give. So the sequence
is split inside a block: a block of `WARPS` warps owns one batch row and
one column of `COLUMN` features (a lane each) and walks the column's
sequence in tiles of `WARPS` x `STEPS` steps, warp w walking its `STEPS`
steps of a tile twice (an aggregate from a zero state, then the outputs
from its carry, the warps' carries folded in shared memory), the next
tile's loads issued before this tile's second walk. Each input element is
read once and each output written once, in one launch. What it leaves: a
column's sequence is not split over blocks, so a shape with fewer columns
than the card has SMs leaves SMs idle.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

from repro_torch.kernels import build

SOURCE = "rglru_scan"
FLAGS = tuple(f for f in build.NVCC_FLAGS if f != "-fmad=false")
WARPS = 8                 # warps a block (the source's WARPS)
STEPS = 16                # steps a warp walks a tile (STEPS)
COLUMN = 32               # features a block, a lane each
SMEM_BYTES = 2 * 2 * WARPS * COLUMN * 4   # the source's SMEM_BYTES
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65_535       # B is the grid's second dimension
MAX_S = 2 ** 30           # step indices are int32 in the source
N_PLAN = 5                # the ints the C function reads from a plan


class LaunchPlan(NamedTuple):
    """One launch: a `grid` of (columns, batch rows) blocks of `block`
    threads (`warps` warps), each block walking its column's `tiles` tiles
    of `warps` x `steps` steps. `cols` columns of `COLUMN` features cover
    D; `smem_bytes` is a block's static shared memory (below the 48 KB
    that needs no opt-in). The kernel needs no workspace."""
    grid: tuple
    block: int
    warps: int
    steps: int
    tiles: int
    cols: int
    smem_bytes: int

    def ints(self) -> tuple:
        """The five ints `rglru_scan_launch` reads and checks against its
        own constants."""
        return (self.warps, self.steps, self.cols, self.tiles,
                self.smem_bytes)


def launch_plan(B: int, S: int, D: int, bf16: bool,
                reverse: bool) -> LaunchPlan:
    """The plan of one launch over ``[B, S, D]``; ``bf16`` and ``reverse``
    change the work, not the plan. Raises ValueError for a shape the grid
    or the source's int32 step indices cannot hold."""
    B, S, D = int(B), int(S), int(D)
    if min(B, S, D) < 1:
        raise ValueError(f"B, S and D must be >= 1, got {B}, {S}, {D}")
    cols = -(-D // COLUMN)
    grid = (cols, B, 1)
    if grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_Y or S > MAX_S:
        raise ValueError(f"[B={B}, S={S}, D={D}] needs a grid of {grid} "
                         f"blocks, beyond ({MAX_GRID_X}, {MAX_GRID_Y}), "
                         f"or S beyond {MAX_S}")
    return LaunchPlan(grid=grid, block=32 * WARPS, warps=WARPS, steps=STEPS,
                      tiles=-(-S // (WARPS * STEPS)), cols=cols,
                      smem_bytes=SMEM_BYTES)


# rglru_scan_launch(bf16, reverse, log_a, x, c0, h0, h_fwd, h, dlog_a,
# h_last, B, S, D, plan, stream)
ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])

_lib = None


def load() -> ctypes.CDLL:
    """The built library with `rglru_scan_launch` typed; builds it on the
    first call."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, FLAGS)
        fn = lib.rglru_scan_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(bf16: bool, reverse: bool, log_a: int, x: int, c0: int, h0: int,
           h_fwd: int, h: int, dlog_a: int, h_last: int, dims,
           plan: LaunchPlan, stream: int) -> int:
    """Enqueue one launch on `stream`. The pointers are device addresses
    (Python ints, 0 for an absent operand) of tensors that are all
    bfloat16 (`bf16`) or all float32, `dims` the three integers
    ``(B, S, D)``, `plan` from `launch_plan`; the C function documents the
    operands of each direction. Returns the launch's `cudaGetLastError()`
    (-1 for refused dims, plan or a missing operand)."""
    B, S, D = (int(d) for d in dims)
    ptr = ctypes.c_void_p
    plan_arr = (ctypes.c_int * N_PLAN)(*plan.ints())
    return int(load().rglru_scan_launch(
        int(bool(bf16)), int(bool(reverse)),
        ptr(log_a), ptr(x), ptr(c0), ptr(h0), ptr(h_fwd), ptr(h),
        ptr(dlog_a), ptr(h_last), B, S, D, plan_arr, ptr(stream)))
