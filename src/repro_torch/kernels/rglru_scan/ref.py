"""Plain PyTorch versions of the diagonal linear recurrence, both ways.

`lru_ref(log_a, b, h0=None)` is the function of the reference's
`repro/kernels/rglru_scan/ref.py :: lru_ref` and of its Pallas kernel
`lru_chunked`: ``h_t = exp(log_a_t) * h_{t-1} + b_t`` over axis 1 of
``[B, S, D]``, from ``h0`` (zero without it), returning ``(h, h_last)`` in
``b.dtype``. The arithmetic is float32 (float64 for float64 inputs, which
only the gradient check uses).

`lru_reverse_ref(log_a, dh, h, h0=None, dh_last=None)` is its backward,
a recurrence of the same form run backwards in time with the decays
shifted by one step:

    g_t      = dh_t + a_{t+1} * g_{t+1}   (a_S = 1; dh_last joins dh_{S-1})
    db_t     = g_t
    dlog_a_t = g_t * a_t * h_{t-1}        (h_{-1} = h0, or 0)
    dh0      = a_0 * g_0

Both run `scan`, which is vectorised so that it takes milliseconds, not a
4 096-step loop, at full width on the card: a walk of `CHUNK` steps inside
every chunk at once, from a zero state, then one pass over the chunks'
carries, ``h = h_local + (product of the decays so far) * carry``.

`lru_tiled(log_a, x, c0, h0, h_fwd, plan=..., reverse=...)` is neither
wrapper's plain version: it walks the CUDA kernel's own decomposition of
the same functions (`kernel.launch_plan`: tiles of warps x steps, a walk
from a zero state per warp chunk, the carries warp by warp and tile by
tile, a second walk from each carry; the reverse as a recurrence in
``q_t = a_t g_t`` with ``h_{t-1}`` shifted across every edge), so that the
tests can hold that decomposition against the reference on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 64


def work_dtype(*xs) -> torch.dtype:
    """float64 if any input is float64, else float32."""
    if any(x is not None and x.dtype == torch.float64 for x in xs):
        return torch.float64
    return torch.float32


def scan(log_a, b, h0=None, chunk: int = CHUNK):
    """``h_t = exp(log_a_t) * h_{t-1} + b_t`` in the work dtype.
    log_a, b: [B, S, D]; h0: optional [B, D]. Returns h [B, S, D]."""
    wt = work_dtype(log_a, b, h0)
    B, S, D = b.shape
    c = min(chunk, S)
    n = -(-S // c)
    a = torch.exp(log_a.to(wt))
    x = b.to(wt)
    if n * c > S:       # as the reference pads: a = 1 carries, b = 0 adds
        a = F.pad(a, (0, 0, 0, n * c - S), value=1.0)
        x = F.pad(x, (0, 0, 0, n * c - S))
    a = a.reshape(B, n, c, D)
    x = x.reshape(B, n, c, D)
    # inside every chunk at once, from a zero state: the local states and
    # the products of the decays since the chunk began
    local = torch.empty_like(x)
    decay = torch.empty_like(a)
    hc, pc = x[:, :, 0], a[:, :, 0]
    local[:, :, 0], decay[:, :, 0] = hc, pc
    for j in range(1, c):
        hc = a[:, :, j] * hc + x[:, :, j]
        pc = pc * a[:, :, j]
        local[:, :, j], decay[:, :, j] = hc, pc
    # the state entering each chunk, chunk after chunk
    carry = (h0.to(wt) if h0 is not None
             else torch.zeros((B, D), dtype=wt, device=b.device))
    starts = torch.empty((B, n, D), dtype=wt, device=b.device)
    for k in range(n):
        starts[:, k] = carry
        carry = decay[:, k, -1] * carry + local[:, k, -1]
    h = local + decay * starts[:, :, None]
    return h.reshape(B, n * c, D)[:, :S]


def lru_ref(log_a, b, h0=None):
    """log_a, b: [B, S, D]; h0: optional [B, D]. Returns (h, h_last), both
    in ``b.dtype``."""
    h = scan(log_a, b, h0)
    return h.to(b.dtype), h[:, -1].to(b.dtype)


def lru_reverse_ref(log_a, dh, h, h0=None, dh_last=None):
    """The backward of `lru_ref` for the incoming gradients ``dh [B, S, D]``
    and ``dh_last [B, D]`` (optional), given the forward's inputs and its
    output ``h``. Returns ``(db, dlog_a, dh0)``: db in ``dh.dtype``, dlog_a
    in ``log_a.dtype``, dh0 in the work dtype."""
    wt = work_dtype(log_a, dh, h, h0, dh_last)
    la = log_a.to(wt)
    # the decay that multiplies g_{t+1} is a_{t+1}; past the end it is 1
    shifted = torch.cat([la[:, 1:], torch.zeros_like(la[:, :1])], dim=1)
    g = scan(shifted.flip(1), dh.to(wt).flip(1), dh_last).flip(1)
    a = torch.exp(la)
    first = (h0.to(wt)[:, None] if h0 is not None
             else torch.zeros_like(la[:, :1]))
    h_prev = torch.cat([first, h[:, :-1].to(wt)], dim=1)
    dlog_a = g * a * h_prev
    return g.to(dh.dtype), dlog_a.to(log_a.dtype), a[:, 0] * g[:, 0]


def lru_tiled(log_a, x, c0=None, h0=None, h_fwd=None, *, plan,
              reverse: bool = False):
    """The kernel's decomposition of `lru_ref` (forward: x = b, c0 = h0;
    returns (h, h_last)) or of `lru_reverse_ref` (reverse: x = dh, c0 =
    dh_last, h0 and h_fwd the forward's; returns (db, dlog_a, dh0)), in
    the work dtype. `plan` gives ``warps``, ``steps`` and ``tiles``. The
    carry enters each tile from the one before it, as the block that walks
    the column keeps it."""
    wt = work_dtype(log_a, x, c0, h0, h_fwd)
    B, S, D = x.shape
    W, c, n = plan.warps, plan.steps, plan.tiles
    pad = n * W * c - S
    la, xs = log_a.to(wt), x.to(wt)
    if reverse:     # walk order is t = S-1 .. 0; h_{t-1} rides with step t
        first = (h0.to(wt)[:, None] if h0 is not None
                 else torch.zeros_like(la[:, :1]))
        hp = torch.cat([first, h_fwd.to(wt)[:, :-1]], dim=1).flip(1)
        hp = F.pad(hp, (0, 0, 0, pad)).reshape(B, n, W, c, D)
        la, xs = la.flip(1), xs.flip(1)
    # past the end log a = 0 and x = 0 carry the state unchanged
    a = torch.exp(F.pad(la, (0, 0, 0, pad))).reshape(B, n, W, c, D)
    xs = F.pad(xs, (0, 0, 0, pad)).reshape(B, n, W, c, D)
    # walk 1, every warp chunk from a zero state: end = A * carry + H
    A = torch.ones((B, n, W, D), dtype=wt)
    H = torch.zeros((B, n, W, D), dtype=wt)
    for u in range(c):
        au, xu = a[:, :, :, u], xs[:, :, :, u]
        H = au * (xu + H) if reverse else au * H + xu
        A = A * au
    # the carries, warp by warp within a tile and tile by tile
    carry = (c0.to(wt) if c0 is not None
             else torch.zeros((B, D), dtype=wt))
    starts = torch.empty((B, n, W, D), dtype=wt)
    for k in range(n):
        for w in range(W):
            starts[:, k, w] = carry
            carry = A[:, k, w] * carry + H[:, k, w]
    # walk 2 from each chunk's carry
    out = torch.empty_like(xs)
    dla = torch.empty_like(xs) if reverse else None
    cc = starts
    for u in range(c):
        if reverse:
            g = xs[:, :, :, u] + cc
            cc = a[:, :, :, u] * g
            out[:, :, :, u], dla[:, :, :, u] = g, cc * hp[:, :, :, u]
        else:
            cc = a[:, :, :, u] * cc + xs[:, :, :, u]
            out[:, :, :, u] = cc
    unpad = lambda t: t.reshape(B, n * W * c, D)[:, :S]
    if reverse:
        return unpad(out).flip(1), unpad(dla).flip(1), carry
    return unpad(out), carry
