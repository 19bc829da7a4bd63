"""The one place that decides where the port's tensors live."""
from __future__ import annotations

import contextlib

import torch

_META_REPEATS = [1]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); anything else is
    taken literally. There is no silent fall-back to the CPU: a caller who
    wants the CPU says ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "explicitly to run the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               f"torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the models' init functions
    draw on ``gen.device``, so with it they build every tensor's shape and
    dtype on the ``meta`` device, allocate no storage and draw nothing (a
    draw on ``meta`` leaves the generator's state as it was)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def meta_generator() -> torch.Generator:
    """The generator to pass to an ``init_params`` for a shape-only build:
    the same init functions as a real build, no second set that could
    drift from them."""
    return _MetaGenerator()


@contextlib.contextmanager
def meta_repeat(n: int):
    """Within the block, a shape-only run (`launch/dryrun.py::MetaRun`)
    counts each operation's FLOPs `n` times: a loop whose steps are alike
    runs one step on ``meta`` in place of `n`."""
    _META_REPEATS.append(_META_REPEATS[-1] * n)
    try:
        yield
    finally:
        _META_REPEATS.pop()


def meta_repeats() -> int:
    """The count `meta_repeat` has set (1 outside it)."""
    return _META_REPEATS[-1]
