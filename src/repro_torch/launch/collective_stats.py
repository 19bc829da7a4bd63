"""The collective traffic of one distributed step, counted as it runs.

The counterpart of the reference's `repro/launch/hlo_stats.py`. The
reference parses XLA's optimized HLO for all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute ops and sums their
operand bytes, scaled by loop trip counts. The port has no HLO: DTensor
issues each collective eagerly as a `_c10d_functional` op, so
`CollectiveRecorder` (a TorchDispatchMode) records every one that a step
issues, with its result bytes and its group size, and `stats` turns the
record into the reference's `CollectiveStats` with its ring factors
(`hlo_stats.py:148-165`, copied here): per-device link traffic of a ring
of g ranks.

    with CollectiveRecorder() as rec:
        step()
    cs = rec.stats()       # op_bytes, op_count, link_bytes_per_device
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

from torch.utils._python_dispatch import TorchDispatchMode

#: the `_c10d_functional` collectives DTensor issues -> the reference's
#: HLO opcodes; any other op of that namespace but these raises
OPCODES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass
class CollectiveStats:
    op_bytes: dict               # opcode -> operand bytes
    op_count: dict               # opcode -> op count
    link_bytes_per_device: float  # ring-model per-device traffic estimate
    n_whiles: int = 0            # the reference's loop count (no loops here)

    def total_bytes(self) -> float:
        return float(sum(self.op_bytes.values()))


def ring_traffic(opcode: str, result_bytes: int, g: int) -> tuple:
    """(operand bytes, per-device link bytes) of one collective whose
    result has `result_bytes`, over a group of `g` ranks, in the ring
    model of the reference (`hlo_stats.py:148-165`):
      all-reduce:     result == operand,  2*(g-1)/g * bytes
      all-gather:     result = g * shard, (g-1)/g * result
      reduce-scatter: operand = g * result, (g-1)/g * operand
      all-to-all:     (g-1)/g * result
      permute:        result"""
    ob = int(result_bytes)
    f = (g - 1) / g
    if opcode == "all-reduce":
        return ob, 2 * f * ob
    if opcode == "all-gather":
        return ob // g, f * ob
    if opcode == "reduce-scatter":
        return ob * g, f * ob * g
    if opcode == "all-to-all":
        return ob, f * ob
    return ob, ob


def stats_of(ops) -> CollectiveStats:
    """`CollectiveStats` of (opcode, result bytes, group size) triples."""
    op_bytes: dict = defaultdict(float)
    op_count: dict = defaultdict(float)
    link = 0.0
    for opcode, ob, g in ops:
        opnd, traffic = ring_traffic(opcode, ob, g)
        op_bytes[opcode] += opnd
        op_count[opcode] += 1
        link += traffic
    return CollectiveStats(op_bytes=dict(op_bytes), op_count=dict(op_count),
                           link_bytes_per_device=link)


def _group_size(args, kwargs) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = kwargs.get("group_name")
    if name is None:
        name = next(a for a in reversed(args) if isinstance(a, str))
    return dist.get_world_size(_resolve_process_group(name))


class CollectiveRecorder(TorchDispatchMode):
    """Records each `_c10d_functional` collective issued under it, in
    order: ``ops`` holds (opcode, result bytes, group size, op name).
    ``skip_local_ops``: `layers.on_shards` sets it aside while a function
    runs on plain local tensors (`partitioning.local_ops_unrecorded`)."""

    skip_local_ops = True

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._opname
        if func.namespace == "_c10d_functional" and \
                name not in NOT_COLLECTIVES:
            if name not in OPCODES:
                raise NotImplementedError(f"collective {func} is not "
                                          f"counted")
            self.ops.append((OPCODES[name], out.numel() * out.element_size(),
                             _group_size(args, kwargs), name))
        return out

    def stats(self) -> CollectiveStats:
        return stats_of((op, ob, g) for op, ob, g, _ in self.ops)


@contextlib.contextmanager
def timed_calls(module, name: str):
    """CUDA events around every call of ``module.name`` in the block (the
    attribute replaced by a timing wrapper, restored after): yields the
    list of (start, end) event pairs. The card only."""
    import torch

    fn = getattr(module, name)
    spans: list = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        stop.record()
        spans.append((start, stop))
        return out

    setattr(module, name, timed)
    try:
        yield spans
    finally:
        setattr(module, name, fn)
