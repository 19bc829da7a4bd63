"""Logical-axis partitioning rules, as the reference names them.

The counterpart of the reference's `repro/sharding/partitioning.py`
(`partitioning.py:24-57`). Every parameter and activation of the
reference is annotated with a tuple of *logical* axis names, and a rule
table maps each logical name to mesh axes; `sharding.policy.resolve`
builds such a table per cell. Mesh axes: ``pod`` (the slowest, pure data
parallel), ``data`` (data parallel, FSDP shards) and ``model`` (tensor and
expert parallel).

`logical_spec` returns the tuple of mesh axes that the reference's
`PartitionSpec` holds, so that a multi-card runner can turn it into
DTensor placements. On one card `constrain` is the identity. The
reference's `logical_sharding` and `shard_params_spec` build
`NamedSharding`s over a device mesh; they belong to the multi-card item of
ROADMAP.md and have no counterpart here.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

# Default rules: tensor parallel on "model", ZeRO-3-style parameter sharding
# of the non-TP dimension over "data", batch over ("pod", "data").
LOGICAL_RULES: dict[str, Optional[str | tuple]] = {
    "batch": ("pod", "data"),
    "attn_batch": ("pod", "data"),  # batch axis *during attention* (the
                                    # policy may extend it over "model")
    "seq": None,
    "kv_seq": None,              # K/V time axis inside attention
    "cache_seq": None,           # KV-cache time axis (flash-decoding)
    "seq_shard": "data",         # sequence parallelism, long-context decode
    "embed": None,
    "embed_fsdp": "data",        # ZeRO-3: shard hidden dim of big matrices
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "expert_cap": None,
    "layers": None,
    "rnn": "model",
    "conv": None,
}

# Pure tensor-parallel rules (no ZeRO): small models / serving.
TP_ONLY_RULES = dict(LOGICAL_RULES, embed_fsdp=None)


def logical_spec(axes: Sequence[Optional[str]],
                 rules: Mapping[str, Optional[str | tuple]] = LOGICAL_RULES
                 ) -> tuple:
    """Tuple of logical axis names -> tuple of mesh axes (None: not
    sharded), the entries of the reference's PartitionSpec."""
    return tuple(rules.get(a) if a is not None else None for a in axes)


def constrain(x, *axes, rules=LOGICAL_RULES):
    """The identity: one card has no layout to constrain."""
    return x
