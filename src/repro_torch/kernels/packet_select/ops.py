"""Public wrapper of the Packet group-formation decision kernel.

`fused_packet_select` takes one decision per row of a ``[T, H]`` batch
(see `ref.py` for the function): the counterpart of the reference's
`repro.kernels.packet_select.ops.fused_packet_select`, with `nonempty` a
bool tensor, `m_free` int32 and float32 or float64 operands.

On CUDA tensors it launches the hand-written kernel
(`repro_torch/csrc/packet_select.cu`) or raises; there is no path from a
failed launch to the plain version. On CPU tensors it runs the plain
PyTorch version (`ref.py`). ``impl="torch"`` asks for the plain version by
name on either device; ``impl="cuda"`` on CPU tensors raises.

`fused_packet_select.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.packet_select import kernel as _kernel
from repro_torch.kernels.packet_select.ref import packet_select_ref
from repro_torch.kernels.routing import check_operand, resolve_impl

DTYPES = (torch.float32, torch.float64)


def fused_packet_select(sum_w, s_j, p_j, oldest, t_max, nonempty, now, k,
                        m_free, *, impl: str | None = None):
    """One Packet decision per row.

    ``sum_w, s_j, p_j, oldest, t_max`` ``[T, H]`` float32 or float64,
    `nonempty` ``[T, H]`` bool, ``now, k`` ``[T]`` in the same dtype,
    `m_free` ``[T]`` int32, all contiguous on one device. Returns
    ``(j [T] int32, m [T], dur [T], work [T])``, `m` an integer-valued
    float.
    """
    if not isinstance(sum_w, torch.Tensor) or sum_w.dim() != 2:
        raise ValueError("sum_w must be a [T, H] tensor")
    device, dtype = sum_w.device, sum_w.dtype
    impl = resolve_impl(impl, device)
    if dtype not in DTYPES:
        raise ValueError(f"operands must be float32 or float64, got {dtype}")
    T, H = (int(d) for d in sum_w.shape)
    if T < 1 or H < 1:
        raise ValueError(f"need at least one row and one type, got "
                         f"[{T}, {H}]")
    for name, x, shape, dt in (
            ("sum_w", sum_w, (T, H), dtype), ("s_j", s_j, (T, H), dtype),
            ("p_j", p_j, (T, H), dtype), ("oldest", oldest, (T, H), dtype),
            ("t_max", t_max, (T, H), dtype),
            ("nonempty", nonempty, (T, H), torch.bool),
            ("now", now, (T,), dtype), ("k", k, (T,), dtype),
            ("m_free", m_free, (T,), torch.int32)):
        check_operand(name, x, shape, dt, device)
    if impl == "torch":
        return packet_select_ref(sum_w, s_j, p_j, oldest, t_max, nonempty,
                                 now, k, m_free)

    j = torch.empty((T,), dtype=torch.int32, device=device)
    m, dur, work = (torch.empty((T,), dtype=dtype, device=device)
                    for _ in range(3))
    inputs = (sum_w, s_j, p_j, oldest, t_max, nonempty, now, k, m_free)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel.launch(dtype == torch.float64,
                             [x.data_ptr() for x in inputs],
                             [x.data_ptr() for x in (j, m, dur, work)],
                             T, H, stream)
    if err != 0:
        raise RuntimeError(f"packet_select kernel launch failed: "
                           f"cudaGetLastError() = {err}")
    fused_packet_select.launches += 1
    return j, m, dur, work


fused_packet_select.launches = 0
