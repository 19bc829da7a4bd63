"""Public wrappers of the RG-LRU recurrence kernel, with its gradient.

`lru_chunked(log_a, b, h0=None)` takes ``log_a, b [B, S, D]`` and an
optional ``h0 [B, D]`` and returns ``(h, h_last)`` in ``b.dtype``: the
function of the reference's `repro.kernels.rglru_scan.kernel.lru_chunked`.
`chunked_lru(a, bx, h0=None)` is the model-facing form of the reference's
`ops.py`: it takes the decays themselves, clamps them at 1e-37 before the
log (outside the kernel, as the reference does) and returns h.

Under autograd both go through `LRUFunction`, whose backward is the
reverse walk of the same recurrence (see `ref.py`). The forward and the
reverse run through the same implementation: on CUDA tensors the
hand-written kernel (`repro_torch/csrc/rglru_scan.cu`) or an exception,
on CPU tensors the plain PyTorch version; ``impl="torch"`` asks for the
plain version by name and ``impl="cuda"`` on CPU tensors raises. On
``meta`` tensors each direction runs the kernel's meta function
(`lru_forward_meta`, `lru_reverse_meta`, `torch.library` ops): the
outputs' shapes and dtypes, nothing computed, with the kernel's
operations (2 an element forward, 4 reverse) registered with
`torch.utils.flop_counter` for a dry run.

`lru_forward.launches` and `lru_reverse.launches` count kernel launches of
each direction (and nothing else).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.rglru_scan import kernel as _kernel
from repro_torch.kernels.rglru_scan.ref import lru_ref, lru_reverse_ref
from repro_torch.kernels.routing import resolve_impl

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
PLAIN_DTYPES = KERNEL_DTYPES + (torch.float64,)
A_FLOOR = 1e-37          # the reference's clamp before the log (ops.py:18)


def _check(log_a, b, h0):
    for name, x in (("log_a", log_a), ("b", b)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(x).__name__}")
        if x.dim() != 3:
            raise ValueError(f"{name} must be [B, S, D], got shape "
                             f"{tuple(x.shape)}")
        if x.dtype not in PLAIN_DTYPES:
            raise ValueError(f"{name} must be one of {PLAIN_DTYPES}, got "
                             f"{x.dtype}")
    if log_a.shape != b.shape or min(b.shape) < 1:
        raise ValueError(f"log_a {tuple(log_a.shape)} and b "
                         f"{tuple(b.shape)} must be the same non-empty shape")
    if log_a.device != b.device:
        raise ValueError(f"log_a lives on {log_a.device}, b on {b.device}")
    if h0 is not None:
        B, _, D = b.shape
        if not isinstance(h0, torch.Tensor) or tuple(h0.shape) != (B, D):
            raise ValueError(f"h0 must be a [B={B}, D={D}] tensor")
        if h0.device != b.device:
            raise ValueError(f"h0 lives on {h0.device}, b on {b.device}")


def _launch(reverse: bool, log_a, x, c0=None, h0=None, h_fwd=None):
    """One kernel launch: forward (h, h_last) in x's dtype, or reverse
    (g, dlog_a in log_a's dtype, the gradient of h0). A float32 / bfloat16
    pair is widened to float32 first, exactly, so the kernel reads one
    type."""
    for name, t in (("log_a", log_a), ("b", x)):
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"the CUDA kernel takes {KERNEL_DTYPES}; "
                             f"{name} is {t.dtype}")
    B, S, D = x.shape
    a_dtype, x_dtype = log_a.dtype, x.dtype
    dt = x_dtype if a_dtype == x_dtype else torch.float32
    plan = _kernel.launch_plan(B, S, D, dt == torch.bfloat16, reverse)
    log_a, x = log_a.to(dt).contiguous(), x.to(dt).contiguous()
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    c0, h0 = f32(c0), f32(h0)
    if reverse:
        h_fwd = h_fwd.to(dt).contiguous()
    out = torch.empty_like(x)
    last = torch.empty((B, D), dtype=dt, device=x.device)
    dlog_a = torch.empty_like(log_a) if reverse else None
    addr = lambda t: 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel.launch(
            dt == torch.bfloat16, reverse, addr(log_a), addr(x), addr(c0),
            addr(h0), addr(h_fwd), addr(out), addr(dlog_a), addr(last),
            (B, S, D), plan, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: "
                           f"cudaGetLastError() = {err}")
    if reverse:
        return out.to(x_dtype), dlog_a.to(a_dtype), last.float()
    return out.to(x_dtype), last.to(x_dtype)


@torch.library.custom_op("repro_torch::lru_forward_meta", mutates_args=())
def lru_forward_meta(log_a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's meta function (its fake implementation
    below): (h, h_last) in b's dtype. It has no implementation off meta."""
    raise NotImplementedError("lru_forward_meta takes meta tensors only")


@lru_forward_meta.register_fake
def _(log_a, b, h0):
    B, _, D = b.shape
    return torch.empty_like(b), b.new_empty((B, D))


@torch.library.custom_op("repro_torch::lru_reverse_meta", mutates_args=())
def lru_reverse_meta(log_a: torch.Tensor, dh: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse kernel's meta function (its fake implementation
    below): (db, dlog_a, dh0 float32). No implementation off meta."""
    raise NotImplementedError("lru_reverse_meta takes meta tensors only")


@lru_reverse_meta.register_fake
def _(log_a, dh):
    B, _, D = dh.shape
    return (torch.empty_like(dh), torch.empty_like(log_a),
            dh.new_empty((B, D), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.lru_forward_meta)
def _forward_flops(a_shape, b_shape, *args, **kwargs) -> int:
    B, S, D = b_shape
    return 2 * B * S * D          # one multiply-add an element


@register_flop_formula(torch.ops.repro_torch.lru_reverse_meta)
def _reverse_flops(a_shape, dh_shape, *args, **kwargs) -> int:
    B, S, D = dh_shape
    return 4 * B * S * D          # an add and two multiplies, and the exp


def lru_forward(log_a, b, h0=None, impl: str | None = None):
    """The forward recurrence, no autograd: (h, h_last) in ``b.dtype``."""
    _check(log_a, b, h0)
    impl = resolve_impl(impl, b.device, meta=True)
    if impl == "meta":
        return lru_forward_meta(log_a, b, h0)
    if impl == "torch":
        return lru_ref(log_a, b, h0)
    h, last = _launch(False, log_a, b, c0=h0)
    lru_forward.launches += 1
    return h, last


def lru_reverse(log_a, dh, h, h0=None, dh_last=None,
                impl: str | None = None):
    """The backward of `lru_forward` (see `ref.lru_reverse_ref`): returns
    (db in dh.dtype, dlog_a in log_a.dtype, dh0 in float32)."""
    _check(log_a, dh, h0)
    if h.shape != dh.shape or h.device != dh.device:
        raise ValueError(f"h {tuple(h.shape)} must be dh's shape "
                         f"{tuple(dh.shape)}, on its device")
    if dh_last is not None and dh_last.shape != dh[:, 0].shape:
        raise ValueError(f"dh_last must be [B, D], got "
                         f"{tuple(dh_last.shape)}")
    impl = resolve_impl(impl, dh.device, meta=True)
    if impl == "meta":
        return lru_reverse_meta(log_a, dh)
    if impl == "torch":
        return lru_reverse_ref(log_a, dh, h, h0, dh_last)
    db, dlog_a, dh0 = _launch(True, log_a, dh, c0=dh_last, h0=h0, h_fwd=h)
    lru_reverse.launches += 1
    return db, dlog_a, dh0


lru_forward.launches = 0
lru_reverse.launches = 0


class LRUFunction(torch.autograd.Function):
    """(log_a, b, h0) -> (h, h_last), with the reverse walk as backward."""

    @staticmethod
    def forward(ctx, log_a, b, h0, impl):
        h, h_last = lru_forward(log_a, b, h0, impl)
        ctx.save_for_backward(log_a, h, h0)
        ctx.impl = impl
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        log_a, h, h0 = ctx.saved_tensors
        db, dlog_a, dh0 = lru_reverse(log_a, dh, h, h0, dh_last, ctx.impl)
        return (dlog_a, db, None if h0 is None else dh0.to(h0.dtype), None)


def lru_chunked(log_a, b, h0=None, *, impl: str | None = None):
    """log_a, b: [B, S, D]; h0: optional [B, D]. Returns (h, h_last) in
    ``b.dtype``, differentiable in log_a, b and h0."""
    _check(log_a, b, h0)
    impl = resolve_impl(impl, b.device, meta=True)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (log_a, b, h0)):
        return LRUFunction.apply(log_a, b, h0, impl)
    return lru_forward(log_a, b, h0, impl)


def chunked_lru(a, bx, h0=None, *, impl: str | None = None):
    """Model-facing API: the decay a (not its log), as `rglru_gates` makes
    it. a, bx: [B, S, D]; returns h [B, S, D] in ``bx.dtype``."""
    log_a = torch.log(torch.clamp_min(a, A_FLOOR))
    h, _ = lru_chunked(log_a, bx, h0, impl=impl)
    return h
