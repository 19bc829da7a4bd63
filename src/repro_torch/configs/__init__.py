"""Configurations of the assigned architectures that the port runs.

``get_config(arch)`` returns the full-size `ModelConfig` of the reference's
`repro/configs/`, copied here for every architecture of ``ARCHS``: the four
dense ones, the MoE qwen2-moe-a2.7b and arctic-480b, the VLM backbone
pixtral-12b, the xLSTM xlstm-1.3b, the hybrid recurrentgemma-2b and the
encoder-decoder seamless-m4t-large-v2; ``smoke_config`` the reduced
same-family config the tests use. The reference's ``SHAPES``, ``cells``
and ``input_specs`` describe its TPU dry-run and are not ported.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCHS: tuple[str, ...] = (
    "qwen2-moe-a2.7b", "arctic-480b", "yi-6b", "phi3-medium-14b",
    "granite-3-2b", "starcoder2-7b", "xlstm-1.3b", "pixtral-12b",
    "recurrentgemma-2b", "seamless-m4t-large-v2",
)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; available: {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def smoke_config(arch: str, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return reduced(get_config(arch), **overrides)
