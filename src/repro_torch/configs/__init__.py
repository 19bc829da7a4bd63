"""Configurations of the assigned architectures that the port runs.

``get_config(arch)`` returns the full-size `ModelConfig` of the reference's
`repro/configs/`, copied here for every architecture of ``ARCHS``: the four
dense ones, the MoE qwen2-moe-a2.7b and arctic-480b, the VLM backbone
pixtral-12b, the xLSTM xlstm-1.3b, the hybrid recurrentgemma-2b and the
encoder-decoder seamless-m4t-large-v2; ``smoke_config`` the reduced
same-family config the tests use.

``SHAPES`` are the assignment's four input-shape cells and ``cells()``
the runnable (arch x shape) grid, 32 cells: ``long_500k`` runs only for
the sub-quadratic archs (``LONG_CONTEXT_ARCHS``), and the 8 skips are
recorded by ``skipped_cells()``, as the reference's
(`repro/configs/__init__.py:32-89`). ``input_specs(cfg, shape)`` gives
the model inputs of one cell as tensors on the ``meta`` device (shapes and
dtypes, no storage), the counterpart of the reference's
`jax.ShapeDtypeStruct`s; `launch/dryrun.py` builds every cell from them.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig, reduced

ARCHS: tuple[str, ...] = (
    "qwen2-moe-a2.7b", "arctic-480b", "yi-6b", "phi3-medium-14b",
    "granite-3-2b", "starcoder2-7b", "xlstm-1.3b", "pixtral-12b",
    "recurrentgemma-2b", "seamless-m4t-large-v2",
)


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

# sub-quadratic archs that run the 500k-context decode cell
LONG_CONTEXT_ARCHS = ("xlstm-1.3b", "recurrentgemma-2b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; available: {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def cells(archs=ARCHS, shapes=None) -> list[tuple[str, str]]:
    """The assigned (arch x shape) grid that runs: 32 of its 40 cells."""
    out = []
    for a in archs:
        for s in (shapes or SHAPES):
            if s == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                continue   # pure full-attention arch: assignment-directed skip
            out.append((a, s))
    return out


def skipped_cells(archs=ARCHS) -> list[tuple[str, str, str]]:
    return [(a, "long_500k",
             "quadratic full attention at 524288 ctx; assignment directs skip")
            for a in archs if a not in LONG_CONTEXT_ARCHS]


def input_specs(cfg: ModelConfig, shape: Shape, device="meta") -> dict:
    """The model inputs of one cell, uninitialised tensors on `device`
    (``meta`` by default: shapes and dtypes only). Integer tokens (and
    labels for a train cell) ``[B, S]`` int32; an encoder-decoder's frames
    ``[B, S, d]`` and a VLM's patch prefix ``[B, n_prefix, d]`` in the
    compute dtype; a decode cell's one new token ``[B, 1]`` (its cache is
    built separately)."""
    B, S = shape.batch, shape.seq
    f = cfg.cdtype()
    tok = lambda s: torch.empty(s, dtype=torch.int32, device=device)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": tok((B, S))}
        if cfg.family == "encdec":
            specs["embeds"] = torch.empty((B, S, cfg.d_model), dtype=f,
                                          device=device)
        elif cfg.embeds_input and cfg.n_prefix:
            specs["embeds"] = torch.empty((B, cfg.n_prefix, cfg.d_model),
                                          dtype=f, device=device)
        if shape.kind == "train":
            specs["labels"] = tok((B, S))
        return specs
    return {"tokens": tok((B, 1))}


def smoke_config(arch: str, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return reduced(get_config(arch), **overrides)
