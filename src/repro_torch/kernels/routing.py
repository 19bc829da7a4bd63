"""Which implementation a kernel wrapper runs, from where its tensors live.

Every wrapper of the port has two implementations: ``"cuda"``, the
hand-written kernel, and ``"torch"``, its plain PyTorch version. With no
choice, CUDA tensors take the kernel and CPU tensors the plain version;
``"cuda"`` asked for on CPU tensors raises. Nothing falls back from one to
the other.

The wrappers of the model path's kernels (flash attention, the RG-LRU
recurrence) also answer on the ``meta`` device (``meta=True``): there
they run the kernel's meta function, which gives the outputs' shapes and
dtypes and computes nothing, as a dry run needs (`launch/dryrun.py`).
The other wrappers take meta tensors to their plain versions.
"""
from __future__ import annotations

import torch

#: the recognized implementations
IMPLS = ("cuda", "torch")


def resolve_impl(impl: str | None, device: torch.device,
                 meta: bool = False) -> str:
    """Default: the kernel on a CUDA device, the plain version on the CPU,
    and, for a wrapper with a meta function (``meta=True``), ``"meta"`` on
    the meta device. ``"cuda"`` on another device raises."""
    if meta and device.type == "meta" and impl in (None, "meta"):
        return "meta"
    if impl is None:
        return "cuda" if device.type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; available: {IMPLS}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors; these live on "
                         f"{device} (use impl='torch' there)")
    return impl


def check_operand(name, x, shape, dtype, device):
    """Raise unless `x` is a contiguous tensor of `shape` and `dtype` on
    `device`: what a kernel wrapper checks before handing a pointer on."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} lives on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
