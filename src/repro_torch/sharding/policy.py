"""The attention policy on one card.

The reference's `repro/sharding/policy.py` resolves, per (arch, mesh,
shape), how attention shards over a TPU mesh and builds the logical-axis
rules its `constrain` calls read. One H100 has no mesh: the only policy
that applies is the reference's `single_device_policy` (`policy.py:81`),
with no KV-head replication and `constrain` the identity. Mesh resolution
(`resolve`) is not applicable to the port and is not stubbed (ROADMAP.md,
model stack).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Policy:
    kv_repeat: int = 1            # KV head replication factor

    def constrain(self, x, *axes):
        """Identity: on one card there is no layout to constrain."""
        return x


def single_device_policy(cfg: ModelConfig) -> Policy:
    """No-op policy for one device (the card, or the CPU in tests)."""
    return Policy()
