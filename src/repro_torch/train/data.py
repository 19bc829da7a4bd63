"""Deterministic synthetic data pipeline: the port's own copy of the
reference's `repro/train/data.py`, numpy only, so that the same
``DataConfig`` gives the same batches, bit for bit.

A reproducible, host-shardable stream of next-token-predictable batches
(an order-k Markov bigram-ish stream), so that training has a real,
decreasing loss signal without external datasets. Each host generates only
its own shard (``host_id`` / ``n_hosts``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq: int = 128
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


def _stream(vocab: int, rng: np.random.Generator, n: int) -> np.ndarray:
    """Tokens where t_{i+1} = (a * t_i + b) % vocab with noisy resets —
    learnable structure with entropy."""
    a = 31 % vocab or 1
    b = 17 % vocab
    toks = np.empty(n, np.int32)
    t = int(rng.integers(vocab))
    for i in range(n):
        toks[i] = t
        if rng.random() < 0.05:
            t = int(rng.integers(vocab))
        else:
            t = (a * t + b) % vocab
    return toks


def batches(cfg: ModelConfig, dc: DataConfig) -> Iterator[dict]:
    """Yields {tokens, labels(, embeds)} numpy batches for this host."""
    if dc.batch % dc.n_hosts:
        raise ValueError(f"batch {dc.batch} is not a multiple of n_hosts "
                         f"{dc.n_hosts}")
    rng = np.random.default_rng(dc.seed * 1009 + dc.host_id)
    B, S = dc.batch // dc.n_hosts, dc.seq
    while True:
        toks = _stream(cfg.vocab_size, rng, B * (S + 1)).reshape(B, S + 1)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if cfg.family == "encdec":
            batch["embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32) * 0.02
        elif cfg.embeds_input and cfg.n_prefix:
            batch["embeds"] = rng.standard_normal(
                (B, cfg.n_prefix, cfg.d_model)).astype(np.float32) * 0.02
            # prefix positions are frontend embeddings, not text: no loss
            batch["labels"][:, :cfg.n_prefix] = -1
        yield batch
