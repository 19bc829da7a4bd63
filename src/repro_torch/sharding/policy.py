"""Per-(arch x mesh x shape) sharding policy resolution.

The counterpart of the reference's `repro/sharding/policy.py`
(`policy.py:53-285`), line for line: the same fields, the same napkin
math over `models.analysis`'s parameter counts, the same float arithmetic
in the same order, so that strategies, rules and the ``notes`` that print
the estimates are the reference's character for character. All of it is
pure Python.

The production mesh is the assignment's: ``("data", "model")`` = (16, 16)
single-pod, ``("pod", "data", "model")`` = (2, 16, 16) multi-pod
(`launch/mesh.py`). `resolve` picks a parallelism strategy for a cell and
builds the logical-rule table; `single_device_policy` is the no-op
policy of one device (every rule None). Training strategies, by estimated
collective bytes a step (P = param bytes, L = layers):

  dp_zero1  batch over every mesh axis, params replicated, optimizer
            sharded over "data": ~ 2P.
  dp_zero3  as dp_zero1 with params sharded (ZeRO-3): ~ 4P.
  tp        Megatron tensor parallel over "model" + ZeRO-3 over "data":
            ~ 4P/tp + per-layer activation all-reduces.
  dp_seq    batch over (pod, data), sequence over "model", K/V gathered
            per attention layer.

Serving always replicates weights over "data"; attention shards by heads
(``tp_heads``, GQA KV heads replicated ``kv_repeat`` x when KV < TP),
falls back to batch-parallel (``dp_batch``) or to none; decode shards the
KV-cache time axis (``seq_kv``) when heads cannot shard.

On one card the models read four things of a policy, as the reference's
do: ``kv_repeat`` (KV heads repeated before attention and in the caches),
``expert_pad`` (the MoE router's and expert stack's width, the padded
experts masked), ``rules["expert"]`` (the MoE dispatch under ``"auto"``)
and ``rules["seq"]`` (a sharded sequence disables query chunking of the
plain attention and the loss's sequence chunks). On a mesh of cards
(`launch/mesh.py::make_mesh`, under `partitioning.mesh_context`) the
rules also lay DTensors out: `Policy.constrain` redistributes to the
placements of logical axes, and the prefill and decode paths run on that
mesh (`launch/dryrun.py --mesh`; ``seq_kv`` decode as flash-decoding over
the cache's time axis, an MoE layer's experts on "model"), and so does
the train step under ``tp``, ``dp_zero1`` and ``dp_zero3`` (`train/step.py`:
ZeRO-3's weights gathered at use, `Policy.at_use`; under ``dp_zero3``
over both axes of the mesh together, one all-gather a weight and one
reduce-scatter of its gradient, `partitioning.whole_over`; an MoE
model's under ``tp`` alone, its experts on "model"). ``dp_seq``, an MoE
model's batch over both axes (``dp_zero1`` / ``dp_zero3``) and the
expert axis's all-to-all wait for ROADMAP.md item 19b, steps 3b and 4.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

from repro_torch.models import analysis
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partitioning

Axis = Optional[str | tuple]

HBM_BUDGET = 12e9          # per-chip bytes the plan may claim (TPU v5e)


def _no_rules() -> dict:
    return {k: None for k in partitioning.LOGICAL_RULES}


@dataclasses.dataclass(frozen=True)
class Policy:
    """A resolved policy. The defaults are `single_device_policy`'s for a
    model without experts."""
    rules: Mapping[str, Axis] = dataclasses.field(default_factory=_no_rules)
    strategy: str = "single"      # tp | dp_zero1 | dp_zero3 | dp_seq |
                                  # serve | single
    attn_mode: str = "tp_heads"   # tp_heads | dp_batch | dp_seq | none
    decode_attn: str = "tp_heads"  # tp_heads | seq_kv | none
    kv_repeat: int = 1            # KV head replication factor (tp_heads)
    expert_pad: int = 0           # padded expert count (0 = not MoE)
    batch_axes: Axis = None       # mesh axes the global batch shards over
    notes: tuple[str, ...] = ()   # human-readable resolution log

    def constrain(self, x, *axes):
        """`partitioning.constrain` by this policy's rules: a DTensor
        redistributed on the current mesh, the identity otherwise."""
        return partitioning.constrain(x, *axes, rules=self.rules)

    def spec(self, axes):
        """The mesh axes of each logical axis (a PartitionSpec's entries)."""
        return partitioning.logical_spec(axes, self.rules)

    def at_use(self, tree):
        """The weights of `tree` (a layer's dict of tensors) made whole
        over the mesh axes ZeRO-3 shards them on (``rules["embed_fsdp"]``,
        `partitioning.whole_over`): on a mesh an all-gather of each such
        weight where it is used, as the reference's ZeRO-3 gathers it in
        the forward, again in the remat recompute, and reduce-scatters its
        gradient; under ``dp_zero3`` (``embed_fsdp`` = ("data", "model"))
        one all-gather over the two axes together, and one reduce-scatter.
        `tree` itself off a mesh or where no rule shards so."""
        axes = self.rules.get("embed_fsdp")
        if not axes or partitioning.current_mesh() is None:
            return tree

        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, list):
                return [walk(v) for v in t]
            return partitioning.whole_over(t, axes)
        return walk(tree)


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def single_device_policy(cfg: ModelConfig) -> Policy:
    """No-op policy for one device (the card, or the CPU in tests)."""
    return Policy(rules=_no_rules(), strategy="single", attn_mode="tp_heads",
                  decode_attn="tp_heads", kv_repeat=1,
                  expert_pad=cfg.n_experts, batch_axes=None)


def _batch_axes_for(mesh_axes, dp_axes, global_batch):
    for cut in range(len(dp_axes), 0, -1):
        axes = dp_axes[:cut]
        if global_batch % _prod(mesh_axes[a] for a in axes) == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def _attn_mode(cfg, tp, dp, global_batch, batch_axes, notes):
    H, KV = cfg.n_heads, cfg.n_kv_heads
    kv_repeat = 1
    if H % tp == 0 and (KV % tp == 0 or tp % KV == 0):
        mode = "tp_heads"
        if KV % tp != 0:
            kv_repeat = tp // KV
            notes.append(f"kv_heads {KV} < TP {tp}: replicated x{kv_repeat}")
    elif batch_axes is not None and global_batch % (dp * tp) == 0:
        mode = "dp_batch"
        notes.append(f"heads {H} % TP {tp} != 0: batch-parallel attention")
    else:
        mode = "none"
        notes.append(f"heads {H} % TP {tp} != 0 and batch {global_batch} % "
                     f"{dp * tp} != 0: attention unsharded on model")
    return mode, kv_repeat


def _train_strategy(cfg: ModelConfig, mesh_axes, global_batch: int,
                    seq: int, notes: list) -> str:
    """Napkin-math candidate selection (bytes per step, lower = better)."""
    tp = mesh_axes.get("model", 1)
    dp = _prod(mesh_axes[a] for a in ("pod", "data") if a in mesh_axes)
    all_chips = dp * tp
    P = analysis.param_count(cfg) * analysis.param_dtype_bytes(cfg)
    mom = 2 * analysis.param_count(cfg) * 4
    d, L = cfg.d_model, cfg.n_layers
    bc = 2 if cfg.compute_dtype == "bfloat16" else 4
    tok = global_batch * seq

    # MoE resharding penalty: dispatch/combine traffic scales with the
    # tokens a rank routes x top_k x capacity factor
    moe_pen = 0.0
    if cfg.n_experts:
        moe_pen = 2.0 * L * cfg.experts_per_token * cfg.capacity_factor \
            * d * bc

    cands: dict[str, float] = {}
    if global_batch % all_chips == 0:
        # per-chip residency: replicated params + sharded moments
        if P + mom / dp + P <= HBM_BUDGET:
            cands["dp_zero1"] = 2.0 * P + moe_pen * tok / all_chips
        if (P + mom) / all_chips * 3 <= HBM_BUDGET and \
                d % all_chips == 0:
            cands["dp_zero3"] = 4.0 * P + moe_pen * tok / all_chips
    tok_col = tok / dp
    if (P + mom) / all_chips * 3 <= HBM_BUDGET:
        # activation-AR coefficients calibrated against the reference's
        # measured HLO traffic; heads that do not divide TP take dp_batch
        # attention (no attention ARs), measured ~0.6x
        coeff = 12.0 if cfg.n_heads % tp == 0 else 7.0
        cands["tp"] = 4.0 * P / tp + coeff * L * tok_col * d * bc \
            + moe_pen * tok_col
    # sequence-parallel DP: batch over (pod, data), seq over "model";
    # K/V all-gathered per attention layer. Not for ssm (the chunked
    # mLSTM reshapes the sequence axis).
    if global_batch % dp == 0 and seq % tp == 0 and cfg.family != "ssm" \
            and (P + mom) / (dp * 3) * 3 <= HBM_BUDGET:
        n_attn = cfg.n_layers if cfg.family != "hybrid" else \
            sum(1 for i in range(cfg.n_layers)
                if (cfg.block_pattern or ("rec", "rec", "attn"))
                [i % len(cfg.block_pattern or (1, 1, 1))] == "attn")
        kv_bytes = (global_batch / dp) * seq * 2 * cfg.n_kv_heads * \
            cfg.hd * bc
        # 6 = fwd + remat-refwd gathers + bwd dK/dV reduce-scatters
        cands["dp_seq"] = 4.0 * P + 6.0 * n_attn * kv_bytes \
            + moe_pen * tok / all_chips
    if not cands:
        cands["tp"] = math.inf
        notes.append("no strategy fits HBM budget cleanly; tp fallback")
    best = min(cands, key=cands.get)
    est = " ".join(f"{k}={v / 1e9:.1f}GB" for k, v in sorted(cands.items()))
    notes.append(f"strategy napkin [{est}] -> {best}")
    return best


def resolve(cfg: ModelConfig, mesh_axes: Mapping[str, int],
            global_batch: int, step: str, seq: int = 4096,
            strategy: str = "auto") -> Policy:
    """Pick a sharding policy.

    Args:
      cfg:          model config (full-size dims).
      mesh_axes:    e.g. {"pod": 2, "data": 16, "model": 16}
                    (`launch.mesh.production_axes`).
      global_batch: batch size of this shape cell.
      step:         "train" | "prefill" | "decode".
      seq:          sequence length (napkin math for strategy choice).
      strategy:     "auto" | "tp" | "dp_zero1" | "dp_zero3" | "dp_seq".
                    "tp" reproduces the reference's baseline.
    """
    tp = mesh_axes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
    dp = _prod(mesh_axes[a] for a in dp_axes)
    all_axes = dp_axes + (("model",) if "model" in mesh_axes else ())
    notes: list[str] = []

    if step == "train":
        strat = _train_strategy(cfg, mesh_axes, global_batch, seq, notes) \
            if strategy == "auto" else strategy
    else:
        strat = "serve"

    rules: dict[str, Axis] = dict(partitioning.LOGICAL_RULES)

    # ---------------- pure data-parallel strategies: model axis joins batch
    if strat in ("dp_zero1", "dp_zero3"):
        batch_axes = all_axes
        for ax in ("heads", "kv_heads", "mlp", "expert", "vocab", "rnn"):
            rules[ax] = None
        rules["batch"] = batch_axes
        rules["attn_batch"] = batch_axes
        rules["cache_seq"] = None
        rules["embed_fsdp"] = all_axes if strat == "dp_zero3" else None
        notes.append(f"{strat}: batch spans {batch_axes}; "
                     f"params {'sharded ' + str(all_axes) if strat == 'dp_zero3' else 'replicated'}")
        return Policy(rules=rules, strategy=strat, attn_mode="tp_heads",
                      decode_attn="tp_heads", kv_repeat=1,
                      expert_pad=cfg.n_experts,
                      batch_axes=batch_axes, notes=tuple(notes))

    # ---------------- sequence-parallel DP: seq over "model", ZeRO on data
    if strat == "dp_seq":
        batch_axes = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        for ax in ("heads", "kv_heads", "mlp", "expert", "vocab", "rnn"):
            rules[ax] = None
        rules["batch"] = batch_axes
        rules["attn_batch"] = batch_axes
        rules["seq"] = "model"
        rules["kv_seq"] = None          # K/V gathered per layer (exact)
        rules["cache_seq"] = None
        rules["embed_fsdp"] = "data"
        notes.append(f"dp_seq: batch over {batch_axes}, seq over model "
                     "(per-layer K/V all-gather), ZeRO-3 over data")
        return Policy(rules=rules, strategy=strat, attn_mode="dp_seq",
                      decode_attn="tp_heads", kv_repeat=1,
                      expert_pad=cfg.n_experts,
                      batch_axes=batch_axes, notes=tuple(notes))

    # ---------------- tensor-parallel (train baseline) / serving
    batch_axes = _batch_axes_for(mesh_axes, dp_axes, global_batch)
    if batch_axes is None:
        notes.append(f"batch {global_batch} not shardable on {dp_axes}: "
                     "replicated")
    attn_mode, kv_repeat = _attn_mode(cfg, tp, dp, global_batch, batch_axes,
                                      notes)
    if step == "decode":
        decode_attn = "tp_heads" if attn_mode == "tp_heads" else "seq_kv"
        if decode_attn == "seq_kv":
            notes.append("decode: KV-cache time axis sharded over model "
                         "(flash-decoding)")
    else:
        decode_attn = "tp_heads" if attn_mode == "tp_heads" else "none"

    expert_pad = 0
    if cfg.n_experts:
        expert_pad = int(math.ceil(cfg.n_experts / tp) * tp)
        if expert_pad != cfg.n_experts:
            notes.append(f"experts {cfg.n_experts} padded to {expert_pad} "
                         f"for EP={tp}")

    rules["batch"] = batch_axes
    if attn_mode == "dp_batch":
        flat = (batch_axes if isinstance(batch_axes, tuple)
                else (batch_axes,) if batch_axes else ())
        rules["attn_batch"] = tuple(flat) + ("model",)
        rules["heads"] = None
        rules["kv_heads"] = None
    elif attn_mode == "tp_heads":
        rules["attn_batch"] = batch_axes
        rules["heads"] = "model"
        rules["kv_heads"] = "model"
    else:
        rules["attn_batch"] = batch_axes
        rules["heads"] = None
        rules["kv_heads"] = None
    rules["cache_seq"] = "model" if decode_attn == "seq_kv" else None
    if strat == "serve":
        # serving never pays ZeRO all-gathers on the latency path
        rules["embed_fsdp"] = None
        notes.append("serve: weights replicated over data (no ZeRO gathers)")
    elif cfg.d_model % max(mesh_axes.get("data", 1), 1) != 0:
        rules["embed_fsdp"] = None
        notes.append("d_model not divisible by data axis: FSDP off")
    return Policy(rules=rules, strategy=strat, attn_mode=attn_mode,
                  decode_attn=decode_attn, kv_repeat=kv_repeat,
                  expert_pad=expert_pad, batch_axes=batch_axes,
                  notes=tuple(notes))
