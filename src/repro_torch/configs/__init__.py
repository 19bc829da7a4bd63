"""Configurations of the assigned architectures that the port runs.

``get_config(arch)`` returns the full-size `ModelConfig` of the reference's
`repro/configs/` (the four dense ones, the MoE qwen2-moe-a2.7b and
arctic-480b, the VLM backbone pixtral-12b and the hybrid recurrentgemma-2b
are copied here); ``smoke_config`` the reduced same-family config the
tests use. The other two architectures of ``ARCHS`` (xlstm-1.3b,
seamless-m4t-large-v2) raise `NotImplementedError` naming their ROADMAP.md
item. The
reference's ``SHAPES``, ``cells`` and ``input_specs`` describe its TPU
dry-run and are not ported.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.lm import UNPORTED_FAMILIES

ARCHS: tuple[str, ...] = (
    "qwen2-moe-a2.7b", "arctic-480b", "yi-6b", "phi3-medium-14b",
    "granite-3-2b", "starcoder2-7b", "xlstm-1.3b", "pixtral-12b",
    "recurrentgemma-2b", "seamless-m4t-large-v2",
)

#: the architectures whose configs live in this package
PORTED_ARCHS = ("yi-6b", "phi3-medium-14b", "granite-3-2b", "starcoder2-7b",
                "qwen2-moe-a2.7b", "arctic-480b", "pixtral-12b",
                "recurrentgemma-2b")

_FAMILY_OF_UNPORTED = {"xlstm-1.3b": "ssm", "seamless-m4t-large-v2": "encdec"}


def get_config(arch: str) -> ModelConfig:
    if arch in _FAMILY_OF_UNPORTED:
        family = _FAMILY_OF_UNPORTED[arch]
        raise NotImplementedError(
            f"{arch} ({family}) is not ported yet "
            f"({UNPORTED_FAMILIES[family]})")
    if arch not in PORTED_ARCHS:
        raise ValueError(f"unknown arch {arch!r}; available: {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def smoke_config(arch: str, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return reduced(get_config(arch), **overrides)
