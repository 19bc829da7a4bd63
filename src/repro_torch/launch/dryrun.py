"""Dry run of the assigned cell grid: does each cell fit, and what does it
cost?

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --cells recurrentgemma-2b:decode_32k,yi-6b:train_4k --out dry.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --cells recurrentgemma-2b:long_500k --run
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.dryrun --cells granite-3-2b:prefill_32k \\
        --run --mesh data=2,model=2
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.dryrun --run \\
        --mesh data=2,model=2 --cells starcoder2-7b:decode_32k

The counterpart of the reference's `repro/launch/dryrun.py`
(`dryrun.py:75-246`), with its command line. For every requested
(architecture x input-shape) cell, on the production single-pod
(16 x 16) or multi-pod (2 x 16 x 16) mesh's axis sizes
(`launch/mesh.py`), `lower_cell`

  * resolves the sharding policy (`sharding.policy.resolve`: strategy,
    attention mode, KV replication, expert padding, batch axes, notes);
    its ``kv_repeat`` and ``expert_pad`` decide the parameter tree;
  * builds the cell's step on the ``meta`` device, with no allocation,
    as the reference's `eval_shape` + `lower` do: train -> `make_train_step`
    with AdamW (bf16 moments for arctic, `_moment_dtype`), prefill ->
    `forward` + `unembed` of the last position, decode ->
    `make_decode_logits_step` against `init_cache(B, seq)` at position
    ``seq - 1``; the model runs ``attention_impl="pallas"``, as the port
    serves and trains, so that the attention and RG-LRU kernels count as
    their meta functions (the outputs they allocate) and the plain
    attention's ``[B, H, Sq, Skv]`` scores never enter;
  * records the parameter count and bytes, the moment, cache and input
    bytes, ``flops`` by `torch.utils.flop_counter`'s formulas (its
    FlopCounterMode's table) over the meta step (matrix products and the
    kernels' registered formulas) beside ``flops_analytic`` = 2 x active
    params x tokens (6 x for train), and an estimate of ONE card's peak
    bytes: the exact argument
    bytes plus the peak of the bytes that the step allocates, storage by
    storage, as the meta run creates and frees them (`MetaRun`).
    ``fits_one_card`` is the estimate at most FIT_SHARE of CARD_BYTES,
    on the assumption that the card's allocator runs with expandable
    segments (see ``--run`` below; ordinary serving and training runs
    use its fixed segments, which can fragment past it); where
    it is not, ``min_cards`` = ceil(estimate / CARD_BYTES), a lower bound
    (the reference shards over 256 or 512 chips; one card's bytes do not
    say how a mesh would split them).

The reference also records XLA's `memory_analysis`; the estimate above
stands where it stood. Its `collectives` block (parsed from the optimized
HLO) is measured by ``--run --mesh`` below.

``--mesh data=2,model=2`` resolves the policy on those axis sizes instead
of the production mesh's, and gives a prefill or decode cell's record a
per-card estimate (`per_card_fit`: one rank's step on meta DTensors of a
fake process group of the mesh's size, metered by `MetaRun`: its shards
of the parameters, inputs and decode cache, and the peak of its
transients, the replicated ones and each all-reduce's whole operand
included; where it exceeds FIT_SHARE of a card, the largest batch whose
estimate fits). With ``--run``, in a process group of as many ranks
(`launch/multihost.py`, one card a rank; torchrun), the cell then runs on
that mesh (`launch/mesh.py::make_mesh`), at its batch where the per-card
estimate fits and at the largest batch that fits where it does not (under
``reduced``): each rank draws the full parameters and inputs from
``--seed`` on its card and keeps its shard of each, in storage of its own
(`param_specs`, `batch_sharding`: the placements of their logical axes
under the policy's rules, `distribute`); a decode cell's cache is laid
out on its family's `cache_axes` and each rank draws only its shard
(`mesh_cache`), as the reference shards the cache it donates
(`dryrun.py:144-162`). The step runs on DTensors (the models' `constrain`
points lay activations out; the kernels, the recurrent families' time
loops and the decode attention run on each rank's local shards, the
decode attention of a cache sharded on its time axis, ``seq_kv``, as
flash-decoding), its logits (a prefill's last position's) gathered to
every rank as the reference's ``out_shardings=repl`` does; the cache stays
sharded. The record gets the reference's ``collectives`` block
(`op_bytes`, `op_count`, `link_bytes_per_device`) measured from the first
step (`launch/collective_stats.py`; a decode step's expected by
`decode_counts`), each rank's bytes (while the parameters and cache are
drawn and distributed, resident after, the peak of the steps) beside the
estimates, and the seconds of the second, warm prefill, or the ms of
RUN_STEPS decode steps after RUN_WARM, split on the card by CUDA events
into their redistributions (all-reduces, gathers, each waited for) and the
rest. ``--batch`` and ``--seq`` cut the cell's batch and length
(recorded under ``reduced``); ``--logits-out`` saves the logits from rank
0, ``--rows-out`` each rank's parts of a decode cache's rows 0 and B - 1
after the steps; ``--records`` takes the cells and their records from an
earlier ``--out`` (the meta work done once, off the ranks). A train cell
on a mesh (``tp`` as `resolve` gives it, or ``--strategy dp_zero1`` /
``dp_zero3``) draws each rank's rows of the synthetic stream
(`mesh_batch`: its place on the batch's mesh axes), the moments on their
parameters' placements, and runs a cold AdamW step (its collectives
recorded, with their group sizes by kind) then RUN_TRAIN_STEPS warm ones,
timed as the prefill's; its per-card estimate counts the rank's
parameter, gradient and moment shards (under ``dp_zero3`` a quarter of
each block weight and of its moments, the embedding table and the norms
whole), its rows (the batch's granule `batch_unit` is 4 under
``dp_zero1`` and ``dp_zero3``), and the peak of forward, remat
recompute, backward and AdamW (under ZeRO-3 one block's gathered weights
at a time, as a transient). A VLM's or an encoder-decoder's ``embeds``
are batch-sharded beside the tokens (`batch_sharding`, `mesh_batch`).
An MoE train cell runs under ``tp`` (`resolve`'s for qwen2-moe-a2.7b):
the einsum dispatch, as the reference's where the experts are sharded,
whose float32 ``[rows, S k, E, C]`` products set its batch; the record
holds each step's aux term (``aux``). ``dp_seq`` on a mesh, an MoE cell
under ``dp_zero1`` / ``dp_zero3``, and the hybrid and xLSTM families'
train cells raise NotImplementedError (ROADMAP.md item 19b, step 3b).

``--run`` (the card only; without one it raises) then runs each requested
cell on the card at its assigned shape if its estimate fits, else at the
largest batch whose estimate fits (recorded under ``reduced``), with
random bf16 weights from ``--seed``: a prefill twice (seconds of the
second), a decode step from a cache whose every (tensor, layer, batch
row) slice is a standard-normal draw of its own seed (`filled_cache`) at
position ``seq - 1`` (ms a step over RUN_STEPS
steps by CUDA events, each step at that position), a train step once.
It records the measured peak (`torch.cuda.max_memory_allocated`) beside
the estimate and the kernel launches. A cell the estimate admits must not
run out of memory: that error is not caught. The estimate counts bytes
allocated, so a cell runs with the caching allocator's expandable
segments (`expandable_segments`), under which the bytes the card must
hold are the bytes allocated: with its fixed segments the allocator
fragments around a prefill's 2.8-8.4 GiB activations (recurrentgemma-2b
prefill_32k at B 18 ran out of memory with 19.3 GiB reserved but
unallocated beside 58.4 GiB allocated, on an H100 80GB HBM3).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _pytree_flatten
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils._pytree import tree_unflatten as _pytree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, Shape, cells, get_config, input_specs
from repro_torch.device import meta_generator, meta_repeats, resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rglru_scan.ops import lru_forward, lru_reverse
from repro_torch.launch import multihost
from repro_torch.launch.collective_stats import CollectiveRecorder
from repro_torch.launch.mesh import (make_mesh, mesh_devices, parse_axes,
                                     production_axes)
from repro_torch.models import analysis
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import padded_vocab, unembed
from repro_torch.models.registry import get_family
from repro_torch.serve.engine import make_decode_logits_step
from repro_torch.sharding import partitioning
from repro_torch.sharding import policy as policy_lib
from repro_torch.train import data as data_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train.step import (check_mesh_train, make_train_step,
                                    shard_batch, state_for)

CARD_BYTES = 80e9        # one H100's HBM
FIT_SHARE = 0.9          # the share of it an estimate may claim
RUN_STEPS = 5            # timed decode steps of --run, after RUN_WARM
RUN_WARM = 2
RUN_TRAIN_STEPS = 2      # timed train steps of --run --mesh, after a cold one
META = torch.device("meta")


def _moment_dtype(cfg: ModelConfig) -> str:
    # >=100B params: bf16 moments (gradient/optimizer compression)
    return "bfloat16" if cfg.name.startswith("arctic") else "float32"


def nbytes(tensors) -> int:
    """Bytes of the tensors' elements (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def tensors_of(tree) -> list:
    """The tensors of a nested structure (dicts, lists, named tuples,
    dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tensors_of(v)]
    return []


class _Uncacheable(Exception):
    """An operand the shape cache does not key (a tensor off meta)."""


def _local(x):
    """A DTensor's local tensor; anything else as it is."""
    return x._local_tensor if partitioning.is_dtensor(x) else x


def _signature(x):
    """What an operand contributes to the shape cache's key."""
    if isinstance(x, torch.Tensor):
        if x.device != META or partitioning.is_dtensor(x):
            raise _Uncacheable
        return (x.shape, x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_signature(y) for y in x)
    return x


class MetaRun(TorchDispatchMode):
    """Runs a step on the meta device and counts its work and its bytes.

    ``flops``: each operation's count by the formulas of
    `torch.utils.flop_counter` (`flop_registry`, FlopCounterMode's table:
    the matrix products and convolutions, and the kernels' meta functions
    that register theirs), summed.

    ``live`` and ``peak``: the bytes of the storages the operations
    create. A storage counts from the operation that creates it until the
    last tensor viewing it dies (a finalizer on the storage), so views and
    in-place results add nothing; the storages of `exclude`d tensors (the
    step's arguments, counted apart) are never counted.

    Shapes are deterministic functions of the operands' metadata, so an
    operation that neither mutates nor aliases is answered, the second time
    it meets the same operands' shapes, strides and dtypes and the same
    other arguments, with new meta tensors of the shapes it gave the first
    time, without running its shape function again: PyTorch's meta
    functions of elementwise operations are Python and cost 0.1-0.4 ms
    each, and the sLSTM's time loop runs ~25 of them a step, 32 768 steps a
    block. ``hits`` counts them.

    On a mesh (the step's tensors DTensors of a fake process group, see
    `per_card_fit`) it counts one rank's bytes: the storages of the local
    tensors, and the results of the collectives that the step issues (an
    all-reduce's operand is the local partial sum before it); FLOPs are not
    counted there (``count_flops=False``): a plain tensor met beside a
    DTensor is sharded inside DTensor's dispatch, out of sight. Operations
    on DTensors are never answered from the cache.
    """

    # no alias annotation in the schema, but a view of the operand
    ALIASING = ("_unsafe_view",)

    def __init__(self, exclude=(), count_flops: bool = True):
        super().__init__()
        self.count_flops = count_flops
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.hits = 0
        self._seen: set[int] = set()
        self._shapes: dict = {}
        self._cacheable: dict = {}
        for t in exclude:
            st = _local(t).untyped_storage()
            self._seen.add(id(st))
            weakref.finalize(st, self._seen.discard, id(st))

    def _free(self, key: int, n: int):
        self._seen.discard(key)
        self.live -= n

    def _key(self, func, args, kwargs):
        """The operation and its operands' metadata, or None where it
        may mutate or alias (or an operand is not hashable, or a tensor
        not on meta)."""
        ok = self._cacheable.get(func)
        if ok is None:
            schema = func._schema
            ok = not (schema.is_mutable or func._opname in self.ALIASING
                      or any(r.alias_info is not None
                             for r in schema.returns))
            self._cacheable[func] = ok
        if not ok:
            return None
        try:
            key = (func, _signature(args),
                   tuple((k, _signature(v)) for k, v in kwargs.items()))
            hash(key)
        except (_Uncacheable, TypeError):
            return None
        return key

    def _run(self, func, args, kwargs):
        key = self._key(func, args, kwargs)
        made = None if key is None else self._shapes.get(key)
        if made is None:
            out = func(*args, **kwargs)
            leaves, spec = _pytree_flatten(out)
            if key is not None and all(
                    o.device == META for o in leaves
                    if isinstance(o, torch.Tensor)):
                # metadata only: a tensor kept here would keep its
                # storage live
                self._shapes[key] = ([
                    (True, (o.shape, o.stride(), o.dtype))
                    if isinstance(o, torch.Tensor) else (False, o)
                    for o in leaves], spec)
            return out
        self.hits += 1
        leaves, spec = made
        return _pytree_unflatten(
            [torch.empty_strided(m[0], m[1], dtype=m[2], device=META)
             if is_tensor else m for is_tensor, m in leaves], spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        count = (flop_registry.get(func._overloadpacket)
                 if self.count_flops else None)
        if count is not None:
            self.flops += meta_repeats() * count(*args, **kwargs,
                                                 out_val=out)
        for t in _pytree_leaves(out):
            t = _local(t)
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = id(st)
                if key not in self._seen:
                    n = st.nbytes()
                    self._seen.add(key)
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, key, n)
        return out


def _at_position(cache, pos: int):
    """The family's decode cache with its next position set to `pos`."""
    return _with_fields(cache, pos=pos)


def row_seed(seed: int, leaf: int, layer: int, row: int) -> int:
    """The seed of one (cache leaf, layer, batch row) slice's draw."""
    digest = hashlib.sha256(f"{seed}:{leaf}:{layer}:{row}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw_rows(t, leaf: int, seed: int, rows, offsets=(), full=None):
    """Fill `t` [layers, b, ...] (a cache leaf, or a rank's shard of one)
    in place: its slice (layer l, row j) with a standard-normal draw of
    the leaf's whole row (`full`, the shape after the batch dim; t's own
    by default) from the generator of ``row_seed(seed, leaf, l,
    rows[j])``, drawn in float32, rounded to t's dtype, cut to t's part
    of it (`offsets`: its first index in each dim after the batch)."""
    full = tuple(full or t.shape[2:])
    cut = tuple(slice(o, o + n) for o, n in
                zip(offsets or (0,) * len(full), t.shape[2:]))
    gen = torch.Generator(device=t.device)
    with torch.no_grad():
        for layer in range(t.shape[0]):
            for j, row in enumerate(rows):
                gen.manual_seed(row_seed(seed, leaf, layer, row))
                t[layer, j].copy_(torch.randn(full, generator=gen,
                                              device=t.device)[cut])


def filled_cache(cfg: ModelConfig, pol, batch: int, seq: int,
                 gen: Optional[torch.Generator], device, rows=None):
    """A decode cache of `seq` positions whose next position is ``seq -
    1``: every (leaf, layer, batch row) slice a standard-normal draw of its
    own (`draw_rows`, seeded by `gen`'s seed), so that any rows drawn
    alone (`rows`: their indices in the whole batch, ``range(batch)`` by
    default) are those rows of the whole draw, bitwise; or shapes only on
    the meta device (`gen` None)."""
    rows = list(range(batch)) if rows is None else list(rows)
    cache = get_family(cfg).init_cache(cfg, pol, len(rows), seq,
                                       device=device)
    if gen is not None:
        for leaf, t in enumerate(tensors_of(cache)):
            draw_rows(t, leaf, gen.initial_seed(), rows)
    return _at_position(cache, seq - 1)


def random_inputs(cfg: ModelConfig, shape: Shape, gen: torch.Generator,
                  device) -> dict:
    """The cell's inputs (`input_specs`) drawn from `gen`: tokens and
    labels uniform over the vocabulary, frames and patch embeddings
    standard normal x 0.02."""
    out = {}
    for name, spec in input_specs(cfg, shape, device=META).items():
        if spec.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=gen, device=device,
                                      dtype=torch.int32)
        else:
            out[name] = (torch.randn(spec.shape, generator=gen,
                                     device=device) * 0.02).to(spec.dtype)
    return out


@dataclasses.dataclass
class Step:
    """One cell's step, built: `fn()` runs it on `args`."""
    fn: object
    params: dict
    state: object          # the moments (train), the cache (decode) or None
    inputs: dict
    tokens: int            # tokens the step processes

    def argument_tensors(self) -> list:
        return tensors_of((self.params, self.state, self.inputs))


def build_step(cfg: ModelConfig, pol, shape: Shape, device,
               gen: Optional[torch.Generator] = None) -> Step:
    """The cell's step on `device`: on the meta device with `gen` None
    (shapes only), else with parameters and data drawn from `gen`."""
    fam = get_family(cfg)
    meta = gen is None
    params = fam.init_params(cfg, pol, meta_generator() if meta else gen)
    inputs = (input_specs(cfg, shape, device=META) if meta
              else random_inputs(cfg, shape, gen, device))
    B, S = shape.batch, shape.seq

    if shape.kind == "train":
        ocfg = optim_lib.AdamWConfig(moment_dtype=_moment_dtype(cfg))
        state = state_for(params, ocfg)
        step = make_train_step(cfg, pol, ocfg)

        def fn():
            return step(state, inputs)[1]["loss"]

        return Step(fn, params, state.opt, inputs, B * S)

    if shape.kind == "prefill":
        def fn():
            with torch.no_grad():
                hidden, _ = fam.forward(cfg, pol, params, inputs["tokens"],
                                        inputs.get("embeds"))
                return unembed(cfg, pol, hidden[:, -1:], params["embed"])

        return Step(fn, params, None, inputs, B * S)

    cache = filled_cache(cfg, pol, B, S, gen, device)
    step = make_decode_logits_step(cfg, pol)

    def fn():
        with torch.no_grad():
            # every step at position seq - 1: the cost of the seq-th token
            logits, _ = step(params, _at_position(cache, S - 1),
                             inputs["tokens"])
            return logits

    return Step(fn, params, cache, inputs, B)


def cell_config(arch: str, remat: Optional[str] = None) -> ModelConfig:
    cfg = get_config(arch).with_(attention_impl="pallas")
    return cfg.with_(remat=remat) if remat is not None else cfg


def estimate(cfg: ModelConfig, pol, shape: Shape) -> dict:
    """The meta build of one cell and what it says: counts, bytes, FLOPs
    and the one-card estimate."""
    t0 = time.perf_counter()
    step = build_step(cfg, pol, shape, META)
    args = step.argument_tensors()
    param_leaves = optim_lib.tree_leaves(step.params)
    with MetaRun(exclude=args) as run:
        out = step.fn()
        del out
    arg_bytes = nbytes(args)
    peak = arg_bytes + run.peak
    state_bytes = nbytes(tensors_of(step.state))
    k = 6 if shape.kind == "train" else 2
    rec = {
        "params": sum(t.numel() for t in param_leaves),
        "param_bytes": nbytes(param_leaves),
        "analysis_params": analysis.param_count(cfg, pol.expert_pad),
        "active_params": analysis.active_param_count(cfg),
        "moment_bytes": state_bytes if shape.kind == "train" else 0,
        "cache_bytes": state_bytes if shape.kind == "decode" else 0,
        "input_bytes": nbytes(tensors_of(step.inputs)),
        "argument_bytes": arg_bytes,
        "transient_bytes": run.peak,
        "peak_bytes_estimate": peak,
        "fits_one_card": peak <= FIT_SHARE * CARD_BYTES,
        "tokens": step.tokens,
        "flops": float(run.flops),
        "flops_analytic": k * analysis.active_param_count(cfg) * step.tokens,
        "meta_seconds": time.perf_counter() - t0,
    }
    if not rec["fits_one_card"]:
        rec["min_cards"] = math.ceil(peak / CARD_BYTES)
        rec["min_cards_is"] = "a lower bound"
    return rec


def policy_record(pol) -> dict:
    return {"strategy": pol.strategy, "attn_mode": pol.attn_mode,
            "decode_attn": pol.decode_attn, "kv_repeat": pol.kv_repeat,
            "expert_pad": pol.expert_pad, "batch_axes": str(pol.batch_axes),
            "notes": list(pol.notes)}


def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """`cfg` with its stack (the encoder's and the decoder's both) cut to
    `layers` layers."""
    if cfg.family == "encdec":
        return cfg.with_(n_layers=layers, n_enc_layers=layers,
                         n_dec_layers=layers)
    return cfg.with_(n_layers=layers)


def resolved_cell(arch: str, shape_name: str, multi_pod: bool = False,
                  remat: Optional[str] = None, strategy: str = "auto",
                  axes: Optional[dict] = None,
                  layers: Optional[int] = None):
    """(cfg, shape, mesh axes, policy) of one cell: the policy resolved
    on the production mesh's axes (or on `axes`) for the cell's batch,
    kind and length; the depth cut to `layers` where given."""
    cfg = cell_config(arch, remat)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    shape = SHAPES[shape_name]
    axes = dict(axes) if axes else production_axes(multi_pod=multi_pod)
    pol = policy_lib.resolve(cfg, axes, shape.batch, shape.kind,
                             seq=shape.seq, strategy=strategy)
    return cfg, shape, axes, pol


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               remat: Optional[str] = None, strategy: str = "auto",
               axes: Optional[dict] = None,
               layers: Optional[int] = None) -> dict:
    """The dry run of one cell on the meta device (its depth cut to
    `layers` where given, recorded as ``cut_layers``). Returns its
    record."""
    cfg, shape, axes, pol = resolved_cell(arch, shape_name, multi_pod,
                                          remat, strategy, axes, layers)
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "batch": shape.batch, "seq": shape.seq,
           "mesh": "x".join(str(s) for s in axes.values()),
           "devices": mesh_devices(axes), "policy": policy_record(pol),
           "attention_impl": cfg.attention_impl, "remat": cfg.remat}
    if layers is not None:
        rec["cut_layers"] = [cell_config(arch).n_layers, layers]
    rec.update(estimate(cfg, pol, shape))
    rec["ok"] = True
    return rec


def largest_fitting_batch(cfg: ModelConfig, pol, shape: Shape, peak=None,
                          unit: int = 1) -> tuple[int, Optional[int]]:
    """The largest batch up to the cell's, a multiple of `unit`, whose
    estimate fits one card, and that estimate ((0, None) if none does): a
    bisection over meta builds. `peak(shape)` gives the estimate (one
    card's, `estimate`, by default)."""
    if peak is None:
        peak = lambda sh: estimate(cfg, pol, sh)["peak_bytes_estimate"]
    lo, hi, est = 0, shape.batch // unit, None
    while lo < hi:
        mid = (lo + hi + 1) // 2
        got = peak(dataclasses.replace(shape, batch=mid * unit))
        if got <= FIT_SHARE * CARD_BYTES:
            lo, est = mid, got
        else:
            hi = mid - 1
    return lo * unit, est


def prefill_counts(cfg: ModelConfig) -> dict:
    """What one prefill of `cfg` launches and, on a mesh whose "model"
    axis has more than one card, how many all-reduces of the activations
    it issues, by the family's layer structure: the attention kernel once
    an attention layer (the encoder's included), the RG-LRU forward once a
    recurrent layer, and an all-reduce after the embedding and after each
    output projection (two a transformer or hybrid layer, three an MoE
    layer with a parallel MLP branch: attention, experts, branch; one an
    xLSTM block, two an encoder layer and three a decoder layer of the
    encoder-decoder: self, cross, MLP). ``aux_all_reduces``: an MoE
    layer's aux-loss sums, [2, E] float32 over the batch's axis."""
    from repro_torch.models import encdec, hybrid, lm

    if cfg.family == "hybrid":
        _, n_rec, n_attn = hybrid._counts(cfg)
        return {"flash_attention": n_attn, "lru_forward": n_rec,
                "all_reduces": 2 * cfg.n_layers + 1}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "lru_forward": 0,
                "all_reduces": cfg.n_layers + 1}
    if cfg.family == "encdec":
        n_enc, n_dec = encdec._n_enc(cfg), encdec._n_dec(cfg)
        return {"flash_attention": n_enc + n_dec, "lru_forward": 0,
                "all_reduces": 2 * n_enc + 3 * n_dec + 1}
    per = 2 + (1 if cfg.n_experts and lm._parallel_ff(cfg) else 0)
    return {"flash_attention": cfg.n_layers, "lru_forward": 0,
            "all_reduces": per * cfg.n_layers + 1,
            "aux_all_reduces": cfg.n_layers if cfg.n_experts else 0}


def decode_counts(cfg: ModelConfig, pol, batch: int, axes: dict) -> dict:
    """The collectives one decode step of `cfg` issues on a mesh of `axes`
    under `pol`, the logits' gathers to every rank with them, by the
    family's layer structure: {kind: [count, operand
    bytes]} as `collective_stats` counts them, a collective over a mesh
    axis of one card left out. With L_r = the rows a rank holds, c the
    compute dtype's bytes:

    - the embedding: an all-reduce of [L_r, 1, d] (c);
    - an attention layer: its output projection's all-reduce of [L_r, 1,
      d]; under ``seq_kv`` instead three over "model": the maxima and the
      sums [L_r, H] float32 and the partial P.V [L_r, H, hd] float32
      (flash-decoding); with ``kv_repeat`` > 1 one relayout of the
      repeated heads [L_r, 1, KVr, hd] (c) onto "kv_heads" (an all-to-all,
      which a process group without one, gloo, makes a gather);
    - an MLP, an MoE layer's experts and its parallel branch, an RG-LRU
      block's output, an encoder-decoder's cross attention: an all-reduce
      of [L_r, 1, d] each; an MoE layer also gathers its router's logits
      [L_r, 1, E] float32; an RG-LRU block reduce-scatters its two gates
      [L_r, 1, dr] float32;
    - an mLSTM block: gathers of the up projection [L_r, 1, 2 di], of the
      conv's output and of the gated output [L_r, 1, di] (c), all-reduces
      of the gates, q and k [L_r, 1, 2H + 2 H dh] float32, of the group
      norm's sum of squares [L_r, 1] float32 and of the down projection;
    - an sLSTM block: gathers of its input projection [L_r, 1, 4d] (c),
      of its recurrence weights [H, d/H, 4d/H] (the param dtype) and of
      the up projection [L_r, 1, 2 ff] (c); the down projection's
      all-reduce;
    - the logits [L_r, 1, Vp] (c): gathered over "model", then [B, 1, Vp]
      over the batch's axis."""
    from repro_torch.models import encdec, hybrid, lm, xlstm

    m, dn = axes.get("model", 1), axes.get("data", 1)
    rows = batch // dn if pol.rules.get("batch") == "data" else batch
    c = torch.empty((), dtype=cfg.cdtype()).element_size()
    pb = torch.empty((), dtype=cfg.pdtype()).element_size()
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    act = rows * d * c
    out: dict = {}

    def add(kind, result, group, n=1):
        if group > 1 and n:
            got = out.setdefault(kind, [0, 0])
            got[0] += n
            got[1] += n * (result // group if kind == "all-gather" else
                           result * group if kind == "reduce-scatter"
                           else result)

    def attention(n):
        if pol.rules.get("cache_seq") is not None:
            add("all-reduce", rows * H * 4, m, 2 * n)
            add("all-reduce", rows * H * hd * 4, m, n)
        else:
            add("all-reduce", act, m, n)
        if pol.kv_repeat > 1:
            add("all-gather", rows * cfg.n_kv_heads * pol.kv_repeat * hd * c,
                m, n)

    add("all-reduce", act, m)                       # the embedding
    if cfg.family == "hybrid":
        _, n_rec, n_attn = hybrid._counts(cfg)
        dr = cfg.d_rnn or d
        attention(n_attn)
        add("reduce-scatter", rows * dr * 4 // m, m, 2 * n_rec)
        add("all-reduce", act, m, n_rec + cfg.n_layers)
    elif cfg.family == "ssm":
        pat = xlstm._pattern(cfg)
        reps = cfg.n_layers // len(pat)
        n_m, n_s = reps * pat.count("m"), reps * pat.count("s")
        di, Hm, dh = xlstm._mlstm_dims(cfg)
        add("all-gather", rows * 2 * di * c, m, n_m)
        add("all-gather", rows * di * c, m, 2 * n_m)
        add("all-reduce", rows * (2 * Hm + 2 * Hm * dh) * 4, m, n_m)
        add("all-reduce", rows * 4, m, n_m)
        add("all-gather", rows * 4 * d * c, m, n_s)
        add("all-gather", 4 * d * d // H * pb, m, n_s)
        add("all-gather", rows * 2 * xlstm._slstm_ff(d) * c, m, n_s)
        add("all-reduce", act, m, n_m + n_s)
    elif cfg.family == "encdec":
        n_dec = encdec._n_dec(cfg)
        attention(n_dec)
        add("all-reduce", act, m, 2 * n_dec)
    else:
        attention(cfg.n_layers)
        per = 1
        if cfg.n_experts:
            E = pol.expert_pad or cfg.n_experts
            add("all-gather", rows * E * 4, m, cfg.n_layers)
            per += 1 if lm._parallel_ff(cfg) else 0
        add("all-reduce", act, m, per * cfg.n_layers)
    Vp = padded_vocab(cfg)
    add("all-gather", rows * Vp * c, m)
    add("all-gather", batch * Vp * c, dn if rows < batch else 1)
    return {k: [float(n), float(b)] for k, (n, b) in out.items()}


def kernel_launches() -> dict:
    return {"flash_attention": flash_attention.launches,
            "lru_forward": lru_forward.launches,
            "lru_reverse": lru_reverse.launches}


def _expandable_segments_on() -> bool:
    """Whether the caching allocator's settings turn expandable segments
    on: the last ones set, where this PyTorch reads them back, else the
    environment's (PYTORCH_CUDA_ALLOC_CONF or PYTORCH_ALLOC_CONF)."""
    get = getattr(torch._C, "_accelerator_getAllocatorSettings", None)
    conf = get() if get is not None else (
        os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        or os.environ.get("PYTORCH_ALLOC_CONF", ""))
    return "expandable_segments:true" in conf.replace(" ", "").lower()


@contextlib.contextmanager
def expandable_segments(device):
    """The caching allocator's expandable segments on for the block's new
    allocations (the cached segments released first), and back to the
    caller's setting after it."""
    prior = _expandable_segments_on()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch._C._accelerator_setAllocatorSettings(
            f"expandable_segments:{prior}")


def run_cell(cfg: ModelConfig, pol, shape: Shape, seed: int = 0,
             device=None) -> dict:
    """Run one cell's step on the card at `shape` (see the module's
    docstring), under `expandable_segments`. Returns the measurements."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"--run measures the card; {dev} is not one")
    with expandable_segments(dev):
        return _run_cell(cfg, pol, shape, seed, dev)


def _run_cell(cfg: ModelConfig, pol, shape: Shape, seed: int, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    step = build_step(cfg, pol, shape, dev, gen)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = kernel_launches()
    out = {"batch": shape.batch, "seq": shape.seq,
           "argument_bytes": nbytes(step.argument_tensors()),
           "allocator": "expandable_segments"}
    if shape.kind == "decode":
        for _ in range(RUN_WARM):
            step.fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(RUN_STEPS):
            logits = step.fn()
        stop.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(stop) / RUN_STEPS
        out.update(ms_per_step=ms, steps=RUN_STEPS, warm_steps=RUN_WARM,
                   tokens_per_second=shape.batch * 1e3 / ms)
        result = logits
    else:
        seconds = []
        for _ in range(2 if shape.kind == "prefill" else 1):
            t0 = time.perf_counter()
            result = step.fn()
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
        out.update(seconds=seconds[-1], seconds_each=seconds,
                   tokens_per_second=step.tokens / seconds[-1])
    out["finite"] = bool(torch.isfinite(result.float()).all())
    out["output_shape"] = list(result.shape)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    after = kernel_launches()
    out["launches"] = {k: after[k] - before[k] for k in after}
    del step, result
    return out


def run_requested(rec: dict, seed: int = 0, remat: Optional[str] = None,
                  strategy: str = "auto", device=None) -> dict:
    """--run for one dry-run record: at the assigned shape if it fits,
    else at the largest batch that fits, else not at all."""
    cfg, shape, _, pol = resolved_cell(
        rec["arch"], rec["shape"], rec["devices"] > 256, remat, strategy)
    if rec["fits_one_card"]:
        return run_cell(cfg, pol, shape, seed, device)
    batch, est = largest_fitting_batch(cfg, pol, shape)
    if batch == 0:
        return {"skipped": "the estimate at batch 1 exceeds one card"}
    out = run_cell(cfg, pol, dataclasses.replace(shape, batch=batch), seed,
                   device)
    out["reduced"] = {"batch": [shape.batch, batch],
                      "why": "the largest batch whose estimate fits"}
    out["estimate_at_reduced_batch"] = est
    return out


# --------------------------------------------------------------------------
# A cell on a mesh of cards
# --------------------------------------------------------------------------

def _zip_map(fn, a, b):
    """`fn(x, y)` over two trees of the same dicts and lists."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def param_specs(cfg: ModelConfig, pol, mesh):
    """The tree of `partitioning.Sharding`s of the parameters: each
    leaf's placements from its logical axes (the family's `param_axes`)
    under the policy's rules."""
    return partitioning.map_axes(
        lambda ax: partitioning.logical_sharding(mesh, ax, pol.rules),
        get_family(cfg).param_axes(cfg, pol))


def batch_sharding(cfg: ModelConfig, pol, mesh, specs: dict) -> dict:
    """The inputs' shardings: batch on its leading axis, the rest whole."""
    return {name: partitioning.logical_sharding(
        mesh, ("batch",) + (None,) * (s.dim() - 1), pol.rules)
        for name, s in specs.items()}


def _own_shard(t, sh):
    """`t` (the same full tensor on every rank: no data moves) as a
    DTensor of this rank's shard, in storage of its own: a shard along
    the leading dim is a view, which would keep the whole tensor alive."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    d = distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() == local.numel() * \
            local.element_size():
        return d
    return DTensor.from_local(local.clone(), sh.mesh, sh.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def distribute(tree, shardings):
    """Each tensor of `tree` as a DTensor holding only this rank's shard,
    in storage of its own (`_own_shard`)."""
    return _zip_map(_own_shard, tree, shardings)


def _replicated(x, mesh):
    from torch.distributed.tensor import Replicate
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def mesh_prefill(cfg: ModelConfig, pol, shape: Shape, mesh, seed: int = 0,
                 device=None, positions=None):
    """Draw a cell's parameters and inputs from `seed` on this rank's
    device, keep this rank's shards, and return ``(fn, params, state,
    inputs)``: for a train cell, `state` is the AdamW moments on their
    parameters' placements, the inputs this rank's rows of the synthetic
    stream of `seed` (`mesh_batch`), and `fn()` takes one train step on
    `mesh` (`mesh_train`), returning its loss; for a prefill, `fn()` runs
    it on `mesh` and returns the
    last position's logits (those of `positions` where given), replicated
    on every rank (the reference's ``out_shardings=repl``), and `state` is
    None; for a decode cell, `state` is the cache, each rank drawing only
    its shard (`mesh_cache`), and `fn()` runs one decode step at position
    ``seq - 1`` (`mesh_decode`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = get_family(cfg).init_params(cfg, pol, gen)
    if shape.kind == "train":
        check_mesh_train(cfg, pol)
        params = distribute(params, param_specs(cfg, pol, mesh))
        return mesh_train(cfg, pol, mesh, params,
                          mesh_batch(cfg, pol, shape, mesh, seed, dev))
    inputs = random_inputs(cfg, shape, gen, dev)
    if shape.kind == "decode":
        # the parameters' shards first: the whole tree and the cache's
        # shards need not fit a card together
        params = distribute(params, param_specs(cfg, pol, mesh))
        cache = mesh_cache(cfg, pol, mesh, shape.batch, shape.seq, seed, dev)
        return mesh_decode(cfg, pol, mesh, params, inputs, cache)
    fn, params, inputs = mesh_step(cfg, pol, mesh, params, inputs, positions)
    return fn, params, None, inputs


def mesh_batch(cfg: ModelConfig, pol, shape: Shape, mesh, seed: int,
               device) -> dict:
    """This rank's rows of a train cell's global batch of `shape`: the
    synthetic stream of `seed` (`train/data.py::batches`) with ``host_id``
    / ``n_hosts`` its place on the batch's mesh axes
    (`multihost.batch_data_shard`), in the dtypes of `input_specs`, as
    DTensors of the global batch (`train.step.shard_batch`). The global
    batch is the ranks' shards concatenated in that order."""
    index, count = multihost.batch_data_shard(mesh, pol.batch_axes)
    rows = next(data_lib.batches(cfg, data_lib.DataConfig(
        batch=shape.batch, seq=shape.seq, seed=seed, host_id=index,
        n_hosts=count)))
    specs = input_specs(cfg, dataclasses.replace(shape, batch=1),
                        device=META)
    return shard_batch(pol, mesh, {
        k: torch.from_numpy(v).to(device, specs[k].dtype)
        for k, v in rows.items()})


def mesh_train(cfg: ModelConfig, pol, mesh, params, inputs) -> tuple:
    """A train cell on `mesh` from the parameters already sharded
    (`distribute`) and the batch (DTensors, `mesh_batch`): ``(fn, params,
    moments, inputs)``. `fn()` takes one AdamW step of `make_train_step`
    on the mesh (the moments from `state_for`, on their parameters'
    placements, `_moment_dtype`'s type; the parameters and moments updated
    in place) and returns its loss, whole on every rank; an MoE model's
    aux term of each step is appended to ``fn.aux``."""
    ocfg = optim_lib.AdamWConfig(moment_dtype=_moment_dtype(cfg))
    state = [state_for(params, ocfg)]
    step = make_train_step(cfg, pol, ocfg, mesh=mesh)
    aux = []

    def fn():
        state[0], mets = step(state[0], inputs)
        if "aux" in mets:
            aux.append(mets["aux"])
        return mets["loss"]

    fn.aux = aux
    return fn, params, state[0].opt, inputs


def mesh_step(cfg: ModelConfig, pol, mesh, params, inputs,
              positions=None) -> tuple:
    """`mesh_prefill` from the full parameters and inputs, the same on
    every rank: ``(fn, sharded params, sharded inputs)``."""
    fam = get_family(cfg)
    params = distribute(params, param_specs(cfg, pol, mesh))
    inputs = {k: distribute(v, sh) for (k, v), sh in zip(
        inputs.items(), batch_sharding(cfg, pol, mesh, inputs).values())}

    def fn():
        with torch.no_grad(), partitioning.mesh_context(mesh):
            hidden, _ = fam.forward(cfg, pol, params, inputs["tokens"],
                                    inputs.get("embeds"))
            at = hidden[:, -1:] if positions is None else torch.cat(
                [hidden[:, p:p + 1] for p in positions], dim=1)
            logits = unembed(cfg, pol, at, params["embed"])
            return _replicated(logits, mesh)

    return fn, params, inputs


def _fields(cache) -> list:
    """(name, value) of a decode cache's fields, in order."""
    if dataclasses.is_dataclass(cache):
        return [(f.name, getattr(cache, f.name))
                for f in dataclasses.fields(cache)]
    return list(zip(cache._fields, cache))


def _with_fields(cache, **fields):
    if dataclasses.is_dataclass(cache):
        return dataclasses.replace(cache, **fields)
    return cache._replace(**fields)


def cache_placements(cfg: ModelConfig, pol, mesh) -> dict:
    """{field: placements} of the family's decode cache on `mesh`: each
    tensor's from its logical axes (`cache_axes`) under the policy's
    rules, as the reference shards the cache it donates."""
    return {name: partitioning.logical_placements(mesh, ax, pol.rules)
            for name, ax in _fields(get_family(cfg).cache_axes(cfg))
            if ax != ()}


def distribute_cache(cfg: ModelConfig, pol, mesh, cache):
    """A decode cache of full tensors (the same on every rank) as DTensors
    of this rank's shards (`cache_placements`), in storage of their
    own."""
    places = cache_placements(cfg, pol, mesh)
    return _with_fields(cache, **{
        name: _own_shard(t, partitioning.Sharding(mesh, places[name]))
        for name, t in _fields(cache) if isinstance(t, torch.Tensor)})


def mesh_cache(cfg: ModelConfig, pol, mesh, batch: int, seq: int,
               seed: Optional[int], device):
    """A decode cell's cache on `mesh` as DTensors whose next position is
    ``seq - 1``, each rank holding and drawing only its own shard of each
    tensor (`draw_rows` over its rows, cut to its part of the other dims:
    the same values as `filled_cache` with a generator seeded `seed`); on
    the meta device, shapes only, with `seed` None."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    template = get_family(cfg).init_cache(cfg, pol, batch, seq, device=META)
    places = cache_placements(cfg, pol, mesh)
    fields, leaf = {}, 0
    for name, t in _fields(template):
        if not isinstance(t, torch.Tensor):
            continue
        shape, off = compute_local_shape_and_global_offset(
            t.shape, mesh, places[name])
        local = torch.empty(shape, dtype=t.dtype, device=device)
        if seed is not None:
            draw_rows(local, leaf, seed, range(off[1], off[1] + shape[1]),
                      off[2:], t.shape[2:])
        fields[name] = DTensor.from_local(local, mesh, places[name],
                                          run_check=False, shape=t.shape,
                                          stride=t.stride())
        leaf += 1
    return _at_position(_with_fields(template, **fields), seq - 1)


def mesh_decode(cfg: ModelConfig, pol, mesh, params, inputs, cache) -> tuple:
    """A decode cell on `mesh` from the parameters and cache already
    sharded (`distribute`, `mesh_cache`) and the full inputs (the same on
    every rank): ``(fn, params, cache, sharded inputs)``. `fn()` runs one
    decode step at position ``seq - 1`` (the cost of the seq-th token, as
    `build_step`'s), writing the cache's shards in place, and returns the
    logits replicated on every rank; the cache stays sharded, as the
    reference's ``out_shardings=(repl, cache_shard)``."""
    fam = get_family(cfg)
    inputs = {k: distribute(v, sh) for (k, v), sh in zip(
        inputs.items(), batch_sharding(cfg, pol, mesh, inputs).values())}
    at = cache.pos

    def fn():
        with torch.no_grad(), partitioning.mesh_context(mesh):
            logits, _ = fam.decode_step(cfg, pol, params,
                                        _at_position(cache, at),
                                        inputs["tokens"])
            return _replicated(logits, mesh)

    return fn, params, cache, inputs


def local_rows(cache, rows, pos: int, seq: int) -> dict:
    """This rank's parts of batch rows `rows` of every cache tensor (a
    DTensor's local shard, or a plain tensor whole): {field: [(row,
    offsets of the dims after the batch, tensor on the CPU)]}. A tensor
    with a time axis of `seq` slots (a KV cache) gives only the slot a
    step at `pos` writes (its ring slot where the axis is shorter)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    out = {}
    for name, t in _fields(cache):
        if not isinstance(t, torch.Tensor):
            continue
        if partitioning.is_dtensor(t):
            local = t.to_local()
            _, off = compute_local_shape_and_global_offset(
                t.shape, t.device_mesh, t.placements)
        else:
            local, off = t, (0,) * t.dim()
        parts = []
        for r in rows:
            j = r - off[1]
            if not 0 <= j < local.shape[1]:
                continue
            part, offs = local[:, j], list(off[2:])
            if name in ("k", "v"):          # [layers, T, KVr, hd]
                T = t.shape[2]
                slot = pos % T - off[2]
                if not 0 <= slot < local.shape[2]:
                    continue
                part, offs[0] = part[:, slot:slot + 1], pos % T
            parts.append((r, offs, part.detach().cpu().clone()))
        out[name] = parts
    return out


def _local_tensors(tree) -> list:
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in tensors_of(tree)]


def mesh_estimate(cfg: ModelConfig, pol, shape: Shape, mesh) -> dict:
    """One rank's step of a cell on `mesh`, built on the meta device (the
    parameters, inputs and cache of `mesh_step` / `mesh_decode`, or the
    parameters, moments and batch of `mesh_train`, as meta DTensors) and
    metered by `MetaRun`: this rank's argument bytes (its shards of the
    parameters, inputs and cache or moments), the
    peak of the bytes its step allocates (every local transient: the
    replicated norms and residual stream, each output projection's partial
    sum before its all-reduce, a decode step's float32 copy of one layer's
    K shard and whatever state it gathers, the gathered logits; a train
    step's activations kept for the backward, its remat recompute, its
    gathered ZeRO-3 weights, the gradients and AdamW's float32
    temporaries), their sum
    and the collectives it issues (no FLOPs). On a mesh of a fake process
    group's rank 0 (`per_card_fit`), whose shards are the largest where a
    dim does not divide."""
    t0 = time.perf_counter()
    fam = get_family(cfg)
    params = fam.init_params(cfg, pol, meta_generator())
    inputs = input_specs(cfg, shape, device=META)
    if shape.kind == "train":
        check_mesh_train(cfg, pol)
        inputs = {k: distribute(v, sh) for (k, v), sh in zip(
            inputs.items(), batch_sharding(cfg, pol, mesh, inputs).values())}
        fn, params, cache, inputs = mesh_train(
            cfg, pol, mesh, distribute(params, param_specs(cfg, pol, mesh)),
            inputs)
    elif shape.kind == "decode":
        cache = mesh_cache(cfg, pol, mesh, shape.batch, shape.seq, None,
                           META)
        fn, params, cache, inputs = mesh_decode(
            cfg, pol, mesh, distribute(params, param_specs(cfg, pol, mesh)),
            inputs, cache)
    else:
        cache = None
        fn, params, inputs = mesh_step(cfg, pol, mesh, params, inputs)
    args = _local_tensors((params, cache, inputs))
    with MetaRun(exclude=args, count_flops=False) as run, \
            CollectiveRecorder() as rec:
        out = fn()
        del out
    arg_bytes = nbytes(args)
    cs = rec.stats()
    return {"batch": shape.batch, "argument_bytes": arg_bytes,
            "cache_bytes": (0 if shape.kind == "train"
                            else nbytes(_local_tensors(cache))),
            "moment_bytes": (nbytes(_local_tensors(cache))
                             if shape.kind == "train" else 0),
            "transient_bytes": run.peak,
            "peak_bytes_estimate": arg_bytes + run.peak,
            "fits": arg_bytes + run.peak <= FIT_SHARE * CARD_BYTES,
            "collective_count": cs.op_count,
            "collective_bytes": cs.op_bytes,
            "meta_seconds": time.perf_counter() - t0}


def batch_unit(pol, axes: dict) -> int:
    """The batch's granule on a mesh of `axes`: the product of the sizes
    of the mesh axes it shards over (`Policy.batch_axes`: "data" for a
    prefill, data x model under ``dp_zero1`` and ``dp_zero3``)."""
    names = pol.batch_axes
    names = (() if names is None else (names,) if isinstance(names, str)
             else names)
    return math.prod(axes.get(a, 1) for a in names)


def per_card_fit(cfg: ModelConfig, pol, shape: Shape, axes: dict) -> dict:
    """The per-card estimate of a cell on a mesh of `axes` (`mesh_estimate`)
    at `shape`'s batch and, where it exceeds FIT_SHARE of a card, the
    largest batch (a multiple of the batch axes' size, `batch_unit`) whose
    estimate fits: ``{"batch", "peak_bytes_estimate_per_card",
    "fits_per_card", "batch_that_fits", "estimates": {str(batch): the
    record of each batch built}}``. The meta step runs under a
    single-process fake process group of the mesh's size, so that DTensor
    gives rank 0's local shapes; a process that already belongs to a group
    runs it in a spawned child."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(1, mp_context=ctx) as pool:
            return pool.submit(per_card_fit, cfg, pol, shape, axes).result()
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh_devices(axes))
    try:
        mesh = init_device_mesh("cpu", tuple(axes.values()),
                                mesh_dim_names=tuple(axes))
        estimates = {}

        def peak(sh):
            estimates[str(sh.batch)] = mesh_estimate(cfg, pol, sh, mesh)
            return estimates[str(sh.batch)]["peak_bytes_estimate"]

        full = peak(shape)
        fits = full <= FIT_SHARE * CARD_BYTES
        b = shape.batch
        if not fits:
            b, _ = largest_fitting_batch(cfg, pol, shape, peak,
                                         batch_unit(pol, axes))
        return {"batch": shape.batch, "seq": shape.seq,
                "peak_bytes_estimate_per_card": full,
                "fits_per_card": fits, "batch_that_fits": b,
                "estimates": estimates}
    finally:
        dist.destroy_process_group()


#: functions of a family's prefill whose calls a run on the card times
#: apart (CUDA events): the xLSTM's sLSTM blocks, a time loop on the host
TIMED_CALLS = {"ssm": (("repro_torch.models.xlstm", "slstm_forward"),)}


def run_mesh_cell(cfg: ModelConfig, pol, shape: Shape, mesh, seed: int = 0,
                  device=None, rows_out: str = "") -> tuple:
    """Run a cell on `mesh` (see the module's docstring): a prefill twice,
    a decode cell RUN_WARM + RUN_STEPS steps, a train cell 1 +
    RUN_TRAIN_STEPS steps. Returns (record, logits of the last step; a
    train cell's loss): the collectives of the first step, the seconds of
    the second prefill or the ms a timed decode or train step (a train
    cell's losses), and per rank the bytes
    it holds (its peak while the parameters and cache are drawn and
    distributed, then what stays), the peak of the steps, its argument
    bytes and the kernel launches of one prefill or of the timed decode
    steps (the card's allocator under expandable segments, as
    `run_cell`). On the card the timed steps are also timed by CUDA
    events, whole and per redistribution (`constrain`'s all-reduces and
    gathers, each waited for), with the family's `TIMED_CALLS` apart.
    With `rows_out`, each rank saves its parts of rows 0 and B - 1 of the
    decode cache after the steps (`local_rows`) to ``rows_out.rank<r>``."""
    import importlib

    import torch.distributed as dist

    from repro_torch.launch.collective_stats import timed_calls

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    decode = shape.kind == "decode"
    train = shape.kind == "train"
    ctx = expandable_segments(dev) if on_card else contextlib.nullcontext()
    with ctx:
        fn, params, cache, inputs = mesh_prefill(cfg, pol, shape, mesh,
                                                 seed, dev)
        sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (
            lambda: None)
        sync()
        held = {}
        if on_card:
            held = {"setup_peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "resident_bytes": torch.cuda.memory_allocated(dev)}
            torch.cuda.reset_peak_memory_stats(dev)
        seconds = []
        with CollectiveRecorder() as rec:
            t0 = time.perf_counter()
            logits = fn()
            sync()
        seconds.append(time.perf_counter() - t0)
        losses = [float(logits)] if train else []
        for _ in range(RUN_WARM - 1 if decode else 0):
            fn()
        sync()
        steps = RUN_STEPS if decode else RUN_TRAIN_STEPS if train else 1
        before = kernel_launches()
        with contextlib.ExitStack() as stack:
            timing = {}
            if on_card:
                red = stack.enter_context(partitioning.timed_redistributions())
                spans = {name: stack.enter_context(timed_calls(
                    importlib.import_module(mod), name))
                    for mod, name in TIMED_CALLS.get(cfg.family, ())}
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for _ in range(steps):
                logits = fn()
                if train:
                    losses.append(logits)
            if on_card:
                stop.record()
            sync()
            seconds.append((time.perf_counter() - t0) / steps)
            if on_card:
                by_kind = partitioning.redistribution_ms(red)
                timing = {
                    "device_ms": start.elapsed_time(stop) / steps,
                    "redistribution_ms": {k: [n // steps, ms / steps] for
                                          k, (n, ms) in by_kind.items()},
                    "all_reduce_ms": by_kind.get("all-reduce",
                                                 [0, 0.0])[1] / steps,
                    "rest_ms": (start.elapsed_time(stop) - sum(
                        ms for _, ms in by_kind.values())) / steps,
                    "span_ms": {name: sum(a.elapsed_time(b) for a, b in sp)
                                / steps for name, sp in spans.items()}}
        after = kernel_launches()
        mine = dict(held, **timing, **{
            "launches": {k: after[k] - before[k] for k in after},
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if on_card
                           else None),
            "argument_bytes": nbytes(_local_tensors((params, cache,
                                                     inputs))),
            "cache_bytes": nbytes(_local_tensors(cache)),
            "device": (torch.cuda.get_device_name(dev) if on_card
                       else str(dev))})
        if rows_out and decode:
            torch.save(local_rows(cache, sorted({0, shape.batch - 1}),
                                  cache.pos, shape.seq),
                       f"{rows_out}.rank{multihost.process_index()}")
        aux = getattr(fn, "aux", [])
        del fn, params, cache, inputs
        if on_card:
            # NCCL may set up the world's communicator only now, and needs
            # memory the allocator's cache would otherwise hold
            torch.cuda.empty_cache()
        ranks = [None] * multihost.device_count()
        dist.all_gather_object(ranks, mine)
    cs = rec.stats()
    out = {"batch": shape.batch, "seq": shape.seq, "kind": shape.kind,
           "mesh": {k: int(v) for k, v in zip(mesh.mesh_dim_names,
                                               mesh.mesh.shape)},
           "collectives": {"op_bytes": cs.op_bytes, "op_count": cs.op_count,
                           "link_bytes_per_device": cs.link_bytes_per_device,
                           "group_sizes": sorted({g for _, _, g, _ in
                                                  rec.ops}),
                           "by_group": group_counts(rec.ops)},
           "ranks": ranks,
           "peak_bytes_max": (max(r["peak_bytes"] for r in ranks)
                              if on_card else None),
           "finite": bool(torch.isfinite(logits.float()).all()),
           "output_shape": list(logits.shape)}
    if train:
        out.update(losses=[float(x) for x in losses],
                   aux=[float(x) for x in aux],
                   ms_per_step=(ranks[0]["device_ms"] if on_card
                                else seconds[-1] * 1e3),
                   ms_per_step_host=seconds[-1] * 1e3,
                   first_step_seconds=seconds[0], steps=RUN_TRAIN_STEPS,
                   tokens_per_second=shape.batch * shape.seq / seconds[-1])
        return out, logits
    out["greedy_tokens"] = logits[:, -1].float().argmax(-1).tolist()
    if decode:
        ms = (ranks[0]["device_ms"] if on_card else seconds[-1] * 1e3)
        out.update(ms_per_step=ms, ms_per_step_host=seconds[-1] * 1e3,
                   first_step_seconds=seconds[0], steps=RUN_STEPS,
                   warm_steps=RUN_WARM, position=shape.seq - 1,
                   tokens_per_second=shape.batch * 1e3 / ms)
    else:
        out.update(seconds=seconds[-1], seconds_each=seconds,
                   tokens_per_second=shape.batch * shape.seq / seconds[-1])
    return out, logits


def group_counts(ops) -> dict:
    """{"kind/group size": count} of a `CollectiveRecorder`'s ops: which
    ranks each kind of collective spans (an all-gather over "data" alone
    under ``tp``, over the four ranks under ``dp_zero3``)."""
    out: dict = {}
    for kind, _, group, _ in ops:
        key = f"{kind}/{group}"
        out[key] = out.get(key, 0) + 1
    return out


def run_on_mesh(rec: dict, axes: dict, seed: int = 0, batch=None,
                remat: Optional[str] = None, strategy: str = "auto",
                device=None, rows_out: str = "", seq=None) -> tuple:
    """--run --mesh for one dry-run record: the cell on a mesh of `axes`
    over the process group's ranks, at `batch` if given, else at the
    cell's batch where its per-card estimate (``rec["per_card"]``,
    `per_card_fit`) fits and at the largest batch that fits where it does
    not (recorded under ``reduced``), at the length `seq` where given (a
    cut, recorded under ``reduced``). Returns (run record, logits)."""
    cut = rec.get("cut_layers")
    cfg, shape, _, pol = resolved_cell(rec["arch"], rec["shape"], False,
                                       remat, strategy, axes,
                                       cut[1] if cut else None)
    dev = resolve_device(device)
    full, full_seq = shape.batch, shape.seq
    if batch is not None:
        shape = dataclasses.replace(shape, batch=int(batch))
    if seq is not None:
        shape = dataclasses.replace(shape, seq=int(seq))
    fit = rec.get("per_card")
    if fit is None or fit["batch"] != shape.batch or \
            fit.get("seq", full_seq) != shape.seq:
        fit = per_card_fit(cfg, pol, shape, axes)
    reduced = None
    if batch is not None:
        reduced = {"batch": [full, shape.batch], "why": "given by --batch"}
    elif not fit["fits_per_card"]:
        if not fit["batch_that_fits"]:
            raise RuntimeError(f"{rec['arch']}:{rec['shape']}: the per-card "
                               f"estimate exceeds a card at every batch")
        reduced = {"batch": [full, fit["batch_that_fits"]],
                   "why": "per-card estimate"}
        shape = dataclasses.replace(shape, batch=fit["batch_that_fits"])
    if seq is not None:
        reduced = dict(reduced or {}, seq=[full_seq, shape.seq],
                       why=", ".join(filter(None, [
                           (reduced or {}).get("why"), "seq given by --seq"])))
    at = fit["estimates"][str(shape.batch)]
    mesh = make_mesh(axes, dev.type)
    multihost.assert_mesh_spans_processes(mesh)
    out, logits = run_mesh_cell(cfg, pol, shape, mesh, seed, dev, rows_out)
    out["peak_bytes_estimate_one_card"] = rec["peak_bytes_estimate"]
    out["peak_bytes_estimate_per_card"] = at["peak_bytes_estimate"]
    out["argument_bytes_estimate_per_card"] = at["argument_bytes"]
    if out["peak_bytes_max"] is not None:
        out["peak_over_per_card_estimate"] = (out["peak_bytes_max"]
                                              / at["peak_bytes_estimate"])
    if cut:
        out["reduced"] = dict(reduced or {}, layers=cut,
                              why=", ".join(filter(None, [
                                  (reduced or {}).get("why"),
                                  "depth cut in the record"])))
    if reduced is not None:
        out.setdefault("reduced", reduced)
        if fit["batch"] == full:
            out["peak_bytes_estimate_per_card_at_full_batch"] = \
                fit["peak_bytes_estimate_per_card"]
        out["peak_bytes_estimate_one_card"] = estimate(
            cfg, pol, shape)["peak_bytes_estimate"]
        out["peak_bytes_estimate_one_card_at_full_batch"] = \
            rec["peak_bytes_estimate"]
    return out, logits


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", type=str, default="",
                    help="comma-separated arch:shape list")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", type=str, default=None)
    ap.add_argument("--strategy", type=str, default="auto",
                    choices=["auto", "tp", "dp_zero1", "dp_zero3", "dp_seq"])
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--run", action="store_true",
                    help="also run the cells that fit on the card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=str, default="",
                    help="axis sizes, e.g. data=2,model=2: resolve on them "
                         "and, with --run, run on a mesh of the process "
                         "group's cards")
    ap.add_argument("--batch", type=int, default=None,
                    help="with --run --mesh: the batch, cut from the cell's")
    ap.add_argument("--seq", type=int, default=None,
                    help="with --run --mesh: the length, cut from the "
                         "cell's")
    ap.add_argument("--logits-out", type=str, default="",
                    help="with --run --mesh: save the last position's "
                         "logits (torch.save, from rank 0)")
    ap.add_argument("--rows-out", type=str, default="",
                    help="with --run --mesh, a decode cell: each rank "
                         "saves its parts of rows 0 and B - 1 of the cache "
                         "after the steps to ROWS_OUT.rank<r>")
    ap.add_argument("--records", type=str, default="",
                    help="take the cells and their dry-run records from "
                         "this file (an earlier run's --out) instead of "
                         "building them")
    args = ap.parse_args(argv)
    axes = parse_axes(args.mesh) if args.mesh else None
    joined = False
    if args.run and axes and not multihost.is_initialized():
        multihost.initialize()      # takes this rank's card first
        joined = True
    if args.run:
        resolve_device(None)        # the card, or raise before any work
    lead = multihost.process_index() == 0

    known = {}
    if args.records:
        with open(args.records) as f:
            known = {(r["arch"], r["shape"]): r for r in json.load(f)}
        todo = list(known)
    elif args.all:
        todo = cells()
    else:
        todo = [tuple(c.split(":")) for c in args.cells.split(",") if c]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch, shape in todo:
        for mp in meshes:
            tag = f"{arch}:{shape}:{'multi' if mp else 'single'}"
            try:
                rec = known.get((arch, shape)) or lower_cell(
                    arch, shape, mp, remat=args.remat,
                    strategy=args.strategy, axes=axes)
                fit = ("fits one card" if rec["fits_one_card"] else
                       f">= {rec['min_cards']} cards")
                if lead:
                    print(f"[dryrun] OK   {tag:55s} "
                          f"est={rec['peak_bytes_estimate'] / 1e9:.1f}GB "
                          f"{fit} flops={rec['flops']:.3e} "
                          f"meta={rec['meta_seconds']:.1f}s", flush=True)
            except Exception as e:      # the next cell still runs
                rec = {"arch": arch, "shape": shape,
                       "mesh": "multi" if mp else "single", "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"[dryrun] FAIL {tag:55s} {type(e).__name__}: "
                      f"{str(e)[:200]}", flush=True)
            if rec["ok"] and axes and "per_card" not in rec:
                cut = rec.get("cut_layers")
                cfg, shape_, _, pol = resolved_cell(
                    arch, shape, False, args.remat, args.strategy, axes,
                    cut[1] if cut else None)
                if args.batch is not None:
                    shape_ = dataclasses.replace(shape_, batch=args.batch)
                if args.seq is not None:
                    shape_ = dataclasses.replace(shape_, seq=args.seq)
                rec["per_card"] = per_card_fit(cfg, pol, shape_, axes)
                if lead:
                    est = rec["per_card"]["peak_bytes_estimate_per_card"]
                    print(f"[dryrun] MESH {tag:55s} per-card est="
                          f"{est / 1e9:.1f}GB on {args.mesh}", flush=True)
            if args.run and rec["ok"] and axes:
                rec["run"], logits = run_on_mesh(
                    rec, axes, args.seed, args.batch, args.remat,
                    args.strategy, rows_out=args.rows_out, seq=args.seq)
                if args.logits_out and lead:
                    torch.save(logits.cpu(), args.logits_out)
                del logits
            elif args.run and rec["ok"]:
                rec["run"] = run_requested(rec, args.seed, args.remat,
                                           args.strategy)
            if args.run and rec["ok"] and lead:
                print(f"[dryrun] RUN  {tag:55s} {json.dumps(rec['run'])}",
                      flush=True)
            results.append(rec)

    if args.out and lead:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {len(results)} records -> {args.out}")
    n_ok = sum(1 for r in results if r.get("ok"))
    n_fit = sum(1 for r in results if r.get("fits_one_card"))
    if lead:
        print(f"[dryrun] {n_ok}/{len(results)} cells built on meta, "
              f"{n_fit} fit one card")
    if joined:
        multihost.shutdown()
    if n_ok < len(results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
