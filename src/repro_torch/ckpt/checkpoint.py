"""Fault-tolerant checkpointing: atomic writes, async writer, rotation.

The counterpart of the reference's `repro/ckpt/checkpoint.py`, reading and
writing its file format: one ``ckpt_{step:08d}.npz`` per step, whose keys
are the state's tree paths joined by ``/`` (a dict key, a NamedTuple
field's name, a list index's number), plus a ``__meta__`` entry holding
the metadata JSON (``step`` and the caller's keys) as uint8 bytes. Writes
go to a temp file (`mkstemp` in the same directory) and then `os.replace`,
so a failure mid-write never corrupts the latest checkpoint.

Leaves are tensors (saved from wherever they live), numpy arrays and
Python numbers (`OptState.step`). A bfloat16 leaf is saved as its 2-byte
patterns with numpy dtype ``V2``, which is how numpy stores the
reference's bfloat16 leaves; on restore into a bfloat16 template a ``V2``
leaf is rebuilt from its bytes, so both sides restore each other's files
bitwise. ``None`` is no leaf, as in JAX.

Elastic re-shard is the identity on one card: `restore_checkpoint` puts
every tensor leaf on the template leaf's device (or on `device` if one is
given), in the template leaf's dtype and with its ``requires_grad``.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

_SEP = "/"
_META_KEY = "__meta__"
_FILE = re.compile(r"ckpt_(\d+)\.npz")


def _children(tree):
    """(name, subtree) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _paths(tree, prefix=()):
    """(key, leaf) of every leaf, in a fixed order."""
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            yield _SEP.join(prefix), tree
        return
    for name, sub in kids:
        yield from _paths(sub, prefix + (name,))


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of a leaf that shares no memory with it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _host_copy(leaf) for key, leaf in _paths(tree)}


def _leaf_from(arr: np.ndarray, leaf, key: str, device):
    if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
    if isinstance(leaf, torch.Tensor):
        if arr.dtype == np.dtype("V2"):          # bfloat16 bit patterns
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        t = t.to(device=device or leaf.device, dtype=leaf.dtype)
        return t.requires_grad_(leaf.requires_grad)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)
    return arr


def _unflatten_into(template, flat: dict, device, prefix=()):
    kids = _children(template)
    if kids is None:
        if template is None:
            return None
        key = _SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _leaf_from(flat[key], template, key, device)
    out = [_unflatten_into(sub, flat, device, prefix + (name,))
           for name, sub in kids]
    if isinstance(template, dict):
        return dict(zip((k for k, _ in kids), out))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*out)
    return type(template)(out)


def _write(path: str, step: int, flat: dict, extra_meta: Optional[dict]
           ) -> str:
    os.makedirs(path, exist_ok=True)
    meta = {"step": int(step), **(extra_meta or {})}
    final = os.path.join(path, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat, **{_META_KEY: np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8)})
        os.replace(tmp, final)          # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def save_checkpoint(path: str, step: int, state,
                    extra_meta: Optional[dict] = None) -> str:
    """Atomic synchronous save. Returns the final file path."""
    return _write(path, step, _flatten(state), extra_meta)


def _steps(path: str) -> list[int]:
    return sorted(int(m.group(1)) for f in os.listdir(path)
                  if (m := _FILE.fullmatch(f)))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return steps[-1] if steps else None


def restore_checkpoint(path: str, template, step: Optional[int] = None,
                       device=None):
    """Restore into `template`'s structure (the latest step by default).
    Returns (state, meta). Tensor leaves go to `device`, or to each
    template leaf's own device when it is None."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    with np.load(os.path.join(path, f"ckpt_{step:08d}.npz")) as z:
        flat = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY]).decode()) \
            if _META_KEY in z.files else {"step": step}
    dev = None if device is None else torch.device(device)
    return _unflatten_into(template, flat, dev), meta


class CheckpointManager:
    """Async writer + rotation.

    ``save`` copies the state to host memory synchronously (a copy, never
    a view: the optimizer updates the parameters in place, so a view would
    be written with a later step's values) and writes it on a background
    thread, overlapping the I/O with the next steps; ``wait`` joins the
    writer and re-raises its error. Keeps the newest ``keep`` checkpoints.
    """

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, extra_meta: Optional[dict] = None):
        self.wait()
        flat = _flatten(state)          # snapshot before mutation

        def _run():
            try:
                _write(self.path, step, flat, extra_meta)
                self._rotate()
            except BaseException as e:               # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _rotate(self):
        for s in _steps(self.path)[:-self.keep]:
            os.unlink(os.path.join(self.path, f"ckpt_{s:08d}.npz"))

    def restore_latest(self, template, device=None):
        self.wait()
        return restore_checkpoint(self.path, template, device=device)
