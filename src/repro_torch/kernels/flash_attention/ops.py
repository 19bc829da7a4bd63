"""Public wrapper of the flash-attention kernel, in the model layout.

`flash_attention(q, k, v)` takes ``q [B, Sq, H, hd]`` and ``k``/``v``
``[B, Skv, KV, hd]`` (``H % KV == 0``) and returns ``[B, Sq, H, hd]`` in
``q.dtype``: the function of the reference's
`repro.kernels.flash_attention.ops.flash_attention`.

On CUDA tensors it launches a hand-written kernel
(`repro_torch/csrc/flash_attention.cu`) or raises; there is no path from a
failed launch to the plain version or to the other kernel. Which kernel is
a dispatch by type (`kernel.KIND`): bfloat16 inputs run the Hopper kernel
(`wgmma` tensor-core products fed by TMA copies, p carried into the P.V
product as two bf16 terms; held to the plain version at 2e-2), float32
inputs the CUDA-core kernel (float32 throughout; 2e-5).
`check_launchable` refuses, before anything is built or launched, what the
TMA copies cannot take. On CPU tensors it runs the plain PyTorch version
(`ref.py`). ``impl="torch"`` asks for the plain version by name on either
device; ``impl="cuda"`` on CPU tensors raises. On ``meta`` tensors it runs
the kernel's meta function `attention_meta` (a `torch.library` op): the
output the kernel allocates, nothing computed; its FLOPs, the visible
(query, key) pairs times ``4 hd`` a head, are registered with
`torch.utils.flop_counter`, so that a dry run counts the kernel's work
and never the plain version's ``[B, H, Sq, Skv]`` scores.

Under autograd (grad mode on and an input that requires a gradient) it
goes through `AttentionFunction`: the forward as above, the backward
`ref.attention_bwd_ref` in plain PyTorch on either device. The TPU package
has no backward kernel to port, so this gradient is not a kernel of the
port. Without autograd (serving, under `torch.inference_mode`) the forward
runs as it is.

`flash_attention.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.routing import resolve_impl

DTYPES = tuple(_kernel.KIND)     # the types with a kernel
MAX_GRID_Y = 65535      # B * H is the grid's second dimension


def _check(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(x).__name__}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape "
                             f"{tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} lives on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, q {q.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {q.dtype}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must both be [B={B}, Skv, KV, hd={hd}]; "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if min(B, Sq, Skv, H, KV) < 1 or H % KV:
        raise ValueError(f"need B, Sq, Skv, H, KV >= 1 and H % KV == 0; got "
                         f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV}")


def check_launchable(q, k, v):
    """Raises ValueError for what the kernels cannot take: a grid of more
    than MAX_GRID_Y (b, h) pairs, an input that is not contiguous (the TMA
    tensor maps describe the contiguous model layout), or one whose data
    does not start on a 16-byte boundary (a TMA map's base address)."""
    B, H = q.shape[0], q.shape[2]
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} exceeds the grid's {MAX_GRID_Y}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks leave visible: query row i sits at
    position ``i + Skv - Sq`` and sees the keys at or before it (causal)
    and within ``window`` of it (window > 0). In numpy, so that a flop
    count taken under a dispatch mode does not dispatch it."""
    pos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(pos, Skv - 1) if causal else np.full_like(pos, Skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else \
        np.zeros_like(pos)
    return int(np.maximum(hi - lo + 1, 0).sum())


@torch.library.custom_op("repro_torch::flash_attention_meta",
                         mutates_args=())
def attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: int) -> torch.Tensor:
    """The kernel's meta function (its fake implementation below): the
    output, shape and dtype only. It has no implementation off meta."""
    raise NotImplementedError("attention_meta takes meta tensors only")


@attention_meta.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention_meta)
def _attention_flops(q_shape, k_shape, v_shape, causal, window, *args,
                     **kwargs) -> int:
    """QK^T and P.V over the visible pairs: 2 products of hd a pair."""
    B, Sq, H, hd = q_shape
    return 4 * B * H * hd * visible_pairs(Sq, k_shape[1], causal, window)


def _forward(q, k, v, causal: bool, window: int, softcap: float,
             impl: str):
    if impl == "meta":
        return attention_meta(q, k, v, causal, window)
    if impl == "torch":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)

    check_launchable(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel.launch(
            q.dtype, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), (B, Sq, Skv, H, KV), causal, window, softcap,
            1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"code {err} (see kernel.launch)")
    flash_attention.launches += 1
    return out


class AttentionFunction(torch.autograd.Function):
    """(q, k, v) -> attention; forward by `impl`, backward in plain
    PyTorch (`attention_bwd_ref`), recomputing the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, impl):
        out = _forward(q, k, v, causal, window, softcap, impl)
        ctx.save_for_backward(q, k, v)
        ctx.masks = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd_ref(q, k, v, do, **ctx.masks)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, impl: str | None = None):
    """q: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd] -> [B, Sq, H, hd].

    Query row i sits at absolute position ``i + Skv - Sq``. Rows that see
    no key at all (causal with ``Skv < Sq``) are outside the contract, as
    they are for the reference's kernel."""
    _check(q, k, v)
    impl = resolve_impl(impl, q.device, meta=True)
    window, softcap = int(window), float(softcap)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return AttentionFunction.apply(q, k, v, causal, window, softcap,
                                       impl)
    return _forward(q, k, v, causal, window, softcap, impl)


flash_attention.launches = 0
