"""The train step on a mesh, on the CPU: four gloo ranks against one
process.

One group of four gloo ranks (`test_torch_multihost.run_ranks`) on a data
2 x model 2 mesh runs each case of `CASES` in turn: reduced granite-3-2b
under ``tp`` (forced, as the dry run forces a strategy; ``remat="full"``,
so that ZeRO-3's gathers run in the forward and again in the recompute),
under ``dp_zero1`` (as `resolve` gives it, with two micro-batches of
each rank's rows) and under ``dp_zero3``, reduced seamless-m4t-large-v2
under ``dp_zero1`` (as `resolve` gives it) and ``dp_zero3``, and reduced
pixtral-12b, the VLM family (its ``embeds`` prefix spliced into the
token embedding, its labels -1 there), under ``tp`` (remat), ``dp_zero1``
(two micro-batches) and ``dp_zero3`` (remat), each forced, and reduced
qwen2-moe-a2.7b, the MoE family (4 experts, top-2, 2 experts a "model"
rank, the einsum dispatch), under ``tp`` (remat, one micro-batch), once at
its capacity factor 1.25 and once at 0.5, where choices drop on every
rank. Every rank draws the same float32 parameters from
one seed and keeps its shards (`launch/dryrun.py::distribute`); its rows
are the synthetic stream's shard at its place on the batch's mesh axes
(`multihost.batch_data_shard`). The one process is given the same
parameters and the global batch: the shards concatenated in that order.

Held, for each case:
- the loss and gradient norm of each of two AdamW steps, every gradient
  leaf (reduced to its parameter's placements, then gathered), and the
  first and second moments after the steps: within MESH_RTOL = 1e-5
  relative (relative L2 for a tensor) of the one process. Float32 sums
  over two or four shards in another order; seen: at most 5.5e-6 (a
  moment of ``tp``), 1e-6 for the gradient leaves.
- the parameters after the steps: the relative L2 of the whole tree
  within MESH_RTOL, and each leaf as `tests/test_torch_train.py` holds
  them, counted in elements so that a leaf of 64 may hold one: at most 1
  % of a leaf's elements, or one, beyond 1e-6, every element within 2 lr
  a step. AdamW moves an element whose gradient is near 0 by up to lr on
  one side and not the other, from a gradient difference of 1e-9 (seen:
  one element of 64 in a norm leaf of ``tp`` and of ``dp_zero1``'s
  seamless, 1.8e-6 apart, the rest of every leaf within 1e-6).
- after the first step, the first moment is (1 - b1) times the clipped
  gradient, on each rank's shard (to 1e-6 relative: the same float32
  product).
- each rank's rows (tokens, labels and, for pixtral and seamless,
  ``embeds``) are the reference's `repro.train.data.batches` with
  ``host_id`` its batch coordinate, bit for bit; under ``tp`` the two
  "model" ranks of a data row hold the same rows.
- pixtral's loss in chunks of its prefix's length, so that the first
  chunk of every row is labels -1 only: the count of tokens exact on every
  rank, the mean loss and the gradient norm within MESH_RTOL of one
  process.
- the step's collectives (`CollectiveRecorder`, counts and bytes by
  kind) equal those of the meta step the per-card estimate runs
  (`dryrun.per_card_fit`); under ``tp`` each all-gather is a ZeRO-3
  weight made whole over "data" (twice a weight a layer: forward and
  recompute), none the batch's.
- the mesh runner's own train cell (`dryrun.run_mesh_cell`): each rank's
  argument bytes equal the per-card estimate's, and its losses are
  finite.
- under ``tp`` a layer's all-gathers by arch (`TP_GATHERS_A_LAYER`: the
  ZeRO-3 weights, and an MoE layer's router logits over "model").
- the MoE layers' aux term alone (the CE loss left out) and its gradient
  into every router: one process's within MESH_RTOL on every rank (each
  "model" rank computes the term from the same gathered logits; counted
  once a rank, the routers' gradient was twice one process's).

The one-process steps are held against the JAX reference by
`tests/test_torch_train.py`; together they hold the slice end to end.
Also here: `launch.train --mesh` refuses ``--ckpt-dir``, the train step on
a mesh refuses ``dp_seq``, the MoE family under ``dp_zero1`` /
``dp_zero3`` and with two micro-batches, and the hybrid and xLSTM
families (naming ROADMAP.md item 19b, step 3b), `resolve` gives
qwen2-moe-a2.7b train_4k ``tp``, `batch_data_shard`'s coordinates,
the LM's remat against its plain forward, and the loss's chunk code off a
mesh against `torch.logsumexp`, bit for bit.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.launch import dryrun, multihost
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import FOUR_CARD
from repro_torch.models import moe
from repro_torch.models.registry import get_family
from repro_torch.sharding import partitioning
from repro_torch.sharding.policy import resolve, single_device_policy
from repro_torch.train import data as tdata
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep
from test_torch_multihost import run_ranks
from test_torch_reference import load_reference

BATCH, SEQ, STEPS, SEED = 8, 16, 2, 3
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=10)
MESH_RTOL = 1e-5
#: name -> (arch, strategy given to `resolve`, remat, n_micro, the strategy
#: it resolves to)
CASES = {
    "granite_tp": ("granite-3-2b", "tp", "full", 1, "tp"),
    "granite_dp_zero1": ("granite-3-2b", "auto", "none", 2, "dp_zero1"),
    "seamless_dp_zero1": ("seamless-m4t-large-v2", "auto", "none", 1,
                          "dp_zero1"),
    "granite_dp_zero3": ("granite-3-2b", "dp_zero3", "full", 2, "dp_zero3"),
    "seamless_dp_zero3": ("seamless-m4t-large-v2", "dp_zero3", "none", 1,
                          "dp_zero3"),
    "pixtral_tp": ("pixtral-12b", "tp", "full", 1, "tp"),
    "pixtral_dp_zero1": ("pixtral-12b", "dp_zero1", "none", 2, "dp_zero1"),
    "pixtral_dp_zero3": ("pixtral-12b", "dp_zero3", "full", 1, "dp_zero3"),
    "qwen2moe_tp": ("qwen2-moe-a2.7b", "tp", "full", 1, "tp"),
    "qwen2moe_tp_drops": ("qwen2-moe-a2.7b", "tp", "full", 1, "tp"),
}
#: a case's config overrides: capacity factor 0.5 makes the capacity C = 4
#: of a row's 32 choices over 4 experts, so that choices drop on every rank
OVERRIDES = {"qwen2moe_tp_drops": {"capacity_factor": 0.5}}
MOE = [name for name, case in CASES.items() if case[0] == "qwen2-moe-a2.7b"]


def case_setup(arch, strategy, remat, **overrides):
    """The reduced config (float32, the attention kernel's path: its plain
    version on the CPU) and its train policy on the four-card mesh."""
    cfg = smoke_config(arch, attention_impl="pallas", remat=remat,
                       **overrides)
    return cfg, resolve(cfg, FOUR_CARD, BATCH, "train", seq=SEQ,
                        strategy=strategy)


def case(name):
    """`case_setup` of the case `name` of `CASES`, with its `OVERRIDES`."""
    return case_setup(*CASES[name][:3], **OVERRIDES.get(name, {}))


def moe_aux(cfg, pol, params, tokens):
    """The MoE layers' aux term alone (the CE loss left out) and its
    gradient into each layer's router."""
    _, aux = get_family(cfg).forward(cfg, pol, params, tokens)
    routers = [lp["moe"]["router"] for lp in params["layers"]]
    return aux, torch.autograd.grad(aux, routers)


class DropCount:
    """Stands in for `moe._route_logits` (a rank's local rows on a mesh):
    counts the choices routed past their expert's capacity and all
    choices."""

    def __init__(self):
        self.fn, self.dropped, self.choices = moe._route_logits, 0, 0

    def __call__(self, cfg, logits):
        gate, idx, probs = self.fn(cfg, logits)
        B, S, k = idx.shape
        E = logits.shape[-1]
        counts = torch.nn.functional.one_hot(idx.reshape(B, S * k),
                                             E).sum(1)
        C = moe.capacity(S, k, E, cfg.capacity_factor)
        self.dropped += int((counts - C).clamp(min=0).sum())
        self.choices += idx.numel()
        return gate, idx, probs


def case_shape():
    return dataclasses.replace(SHAPES["train_4k"], batch=BATCH, seq=SEQ)


def full_params(cfg, pol):
    return get_family(cfg).init_params(cfg, pol,
                                       torch.Generator().manual_seed(SEED))


def to_torch(b):
    return {k: torch.from_numpy(v) if k == "embeds" else
            torch.from_numpy(v).long() for k, v in b.items()}


_RANKS = r"""
import json, sys
import torch
from repro_torch.launch import dryrun, mesh as tmesh, multihost
from repro_torch.launch.collective_stats import CollectiveRecorder
from repro_torch.models.registry import get_family
from repro_torch.sharding import partitioning
from repro_torch.train import data as tdata, optim as toptim, step as tstep
from repro_torch.models import moe
from test_torch_mesh_train import (BATCH, CASES, OPT, SEQ, STEPS, SEED,
                                   DropCount, case, case_shape, full_params,
                                   moe_aux, to_torch)

multihost.initialize(timeout_s=60, device="cpu")
m = tmesh.make_mesh(tmesh.FOUR_CARD, "cpu")
rank = multihost.process_index()
out = {}
for name, (arch, strategy, remat, n_micro, _) in CASES.items():
    cfg, pol = case(name)
    specs = dryrun.param_specs(cfg, pol, m)
    params = dryrun.distribute(full_params(cfg, pol), specs)
    index, count = multihost.batch_data_shard(m, pol.batch_axes)
    it = tdata.batches(cfg, tdata.DataConfig(
        batch=BATCH, seq=SEQ, seed=1, host_id=index, n_hosts=count))
    rows = [next(it) for _ in range(STEPS)]
    batches = [tstep.shard_batch(pol, m, to_torch(b)) for b in rows]
    # the gradients of the first batch, reduced to the parameters'
    # placements, then whole
    ocfg = toptim.AdamWConfig(**OPT)
    state = tstep.state_for(params, ocfg)
    grad_fn = tstep.make_grad_fn(cfg, pol, n_micro, mesh=m)
    drops = DropCount()
    if cfg.n_experts:
        moe._route_logits = drops
    _, _, grads = grad_fn(params, batches[0])
    moe._route_logits = drops.fn
    whole_aux = None
    if cfg.n_experts:
        # the aux term alone and its gradient into each router, whole
        with partitioning.mesh_context(m):
            aux, g = moe_aux(cfg, pol, params, batches[0]["tokens"])
        whole_aux = {"aux": aux.full_tensor().detach(),
                     "routers": [x.full_tensor() for x in g]}
        del aux, g
    prefix = None
    if cfg.family == "vlm":
        # loss chunks of the prefix's length: the first chunk of every row
        # is all prefix, every label of it -1
        loss, got, g = tstep.make_grad_fn(cfg, pol, n_micro,
                                          loss_chunk=cfg.n_prefix,
                                          mesh=m)(params, batches[0])
        prefix = [float(loss), int(got["tokens"]),
                  float(toptim.global_norm(g))]
        del g
    step = tstep.make_train_step(cfg, pol, ocfg, n_micro=n_micro, mesh=m)
    mets, ops = [], []
    for i, b in enumerate(batches):
        with CollectiveRecorder() as rec:
            state, got = step(state, b)
        mets.append({k: float(v) for k, v in got.items()})
        ops.append([list(o[:3]) for o in rec.ops])
        if i == 0:
            # the first moment after one step: (1 - b1) x the clipped
            # gradient, on this rank's shards
            scale = min(1.0, ocfg.grad_clip
                        / max(mets[0]["grad_norm"], 1e-9))
            m1 = max(float((mm.to_local() - (1 - ocfg.b1) * scale
                            * g.to_local().float()).norm()
                           / (mm.to_local().norm() + 1e-30))
                     for mm, g in zip(state.opt.m, grads))
    whole = {"grads": [g.full_tensor() for g in grads],
             "params": [p.full_tensor().detach()
                        for p in toptim.tree_leaves(state.params)],
             "m": [x.full_tensor() for x in state.opt.m],
             "v": [x.full_tensor() for x in state.opt.v],
             "aux": whole_aux}
    if rank == 0:
        torch.save(whole, sys.argv[1] + f"/{name}.pt")
    run, _ = dryrun.run_mesh_cell(cfg, pol, case_shape(), m, seed=SEED,
                                  device="cpu")
    out[name] = {
        "shard": [index, count], "strategy": pol.strategy,
        "tokens": [r["tokens"].tolist() for r in rows],
        "labels": [r["labels"].tolist() for r in rows],
        "embeds": ([r["embeds"].tolist() for r in rows]
                   if "embeds" in rows[0] else None),
        "prefix_chunk": prefix, "mets": mets, "ops": ops, "m_after_one": m1,
        "dropped": [drops.dropped, drops.choices],
        "aux": None if whole_aux is None else float(whole_aux["aux"]),
        "fsdp_local": sorted({int(x.to_local().numel()
                                  * x.element_size() * m.size(0))
                              for x in toptim.tree_leaves(params)
                              if x.placements[0].is_shard()}),
        # per leaf: does its logical axes hold embed_fsdp, its whole and
        # this rank's elements, its moments' elements on this rank
        "leaves": [[bool(f), x.numel(), x.to_local().numel(),
                    mm.to_local().numel(), vv.to_local().numel()]
                   for f, x, mm, vv in zip(
                       toptim.tree_leaves(partitioning.map_axes(
                           lambda ax: "embed_fsdp" in ax,
                           get_family(cfg).param_axes(cfg, pol))),
                       toptim.tree_leaves(params), state.opt.m,
                       state.opt.v)],
        "element_size": toptim.tree_leaves(params)[0].element_size(),
        "run_arguments": [r["argument_bytes"] for r in run["ranks"]],
        "run_ops": run["collectives"]["op_count"],
        "run_by_group": run["collectives"]["by_group"],
        "run_losses": run["losses"], "run_finite": run["finite"]}
print(json.dumps(out))
multihost.shutdown()
"""


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on four gloo ranks, in one group."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    outs = run_ranks(_RANKS, 4, tmp)
    return types.SimpleNamespace(outs=outs, tmp=tmp)


@pytest.fixture(scope="module")
def one_process(ranks):
    """Each case in this process: the same parameters, the global batch
    (the ranks' shards concatenated in order), the same steps."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        n_micro = CASES[name][3]
        cfg, mpol = case(name)
        pol = single_device_policy(cfg)
        count = ranks.outs[0][name]["shard"][1]
        its = [tdata.batches(cfg, tdata.DataConfig(
            batch=BATCH, seq=SEQ, seed=1, host_id=i, n_hosts=count))
            for i in range(count)]
        batches = []
        for _ in range(STEPS):
            parts = [next(it) for it in its]
            batches.append(to_torch({k: np.concatenate([p[k] for p in parts])
                                     for k in parts[0]}))
        ocfg = toptim.AdamWConfig(**OPT)
        state = tstep.state_for(full_params(cfg, mpol), ocfg)
        _, _, grads = tstep.make_grad_fn(cfg, pol, n_micro)(state.params,
                                                            batches[0])
        prefix = None
        if cfg.family == "vlm":
            loss, got, g = tstep.make_grad_fn(
                cfg, pol, n_micro, loss_chunk=cfg.n_prefix)(state.params,
                                                            batches[0])
            prefix = [float(loss), int(got["tokens"]),
                      float(toptim.global_norm(g))]
        aux = None
        if cfg.n_experts:
            a, g = moe_aux(cfg, pol, state.params, batches[0]["tokens"])
            aux = {"aux": a.detach(), "routers": list(g)}
        step = tstep.make_train_step(cfg, pol, ocfg, n_micro=n_micro)
        mets = []
        for b in batches:
            state, got = step(state, b)
            mets.append({k: float(v) for k, v in got.items()})
        cache[name] = types.SimpleNamespace(
            mets=mets, prefix_chunk=prefix,
            grads=[g.detach() for g in grads],
            params=[p.detach() for p in toptim.tree_leaves(state.params)],
            m=state.opt.m, v=state.opt.v, aux=aux,
            mesh=torch.load(ranks.tmp / f"{name}.pt"))
        return cache[name]
    return get


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_resolved_strategy(ranks, name):
    assert ranks.outs[0][name]["strategy"] == CASES[name][4]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grad_norm_match_one_process(ranks, one_process, name):
    one = one_process(name)
    for r, out in enumerate(ranks.outs):
        for got, want in zip(out[name]["mets"], one.mets):
            for key in ("loss", "grad_norm"):
                assert got[key] == pytest.approx(want[key], rel=MESH_RTOL,
                                                 abs=0), (r, key)
            assert got["tokens"] == want["tokens"]


VLM = [name for name, case in CASES.items() if case[0] == "pixtral-12b"]


@pytest.mark.parametrize("name", VLM)
def test_prefix_only_loss_chunks_match_one_process(ranks, one_process, name):
    """Loss chunks of the prefix's length, so that the first chunk of every
    row holds only prefix positions (labels -1): on every rank the count of
    tokens is one process's exactly, the text positions alone, and the
    mean loss and the gradient norm are one process's."""
    one = one_process(name)
    cfg, _ = case(name)
    loss, tokens, norm = one.prefix_chunk
    # the count is the last micro-batch's, as the step's metrics are
    assert tokens == BATCH // CASES[name][3] * (SEQ - cfg.n_prefix)
    assert tokens == one.mets[0]["tokens"]
    for r, out in enumerate(ranks.outs):
        got = out[name]["prefix_chunk"]
        assert got[1] == tokens, r
        assert got[0] == pytest.approx(loss, rel=MESH_RTOL, abs=0), r
        assert got[2] == pytest.approx(norm, rel=MESH_RTOL, abs=0), r


@pytest.mark.parametrize("name", list(CASES))
def test_every_gradient_leaf_matches_one_process(one_process, name):
    one = one_process(name)
    assert len(one.mesh["grads"]) == len(one.grads)
    for i, (got, want) in enumerate(zip(one.mesh["grads"], one.grads)):
        assert got.shape == want.shape
        assert rel_l2(got, want) <= MESH_RTOL, i


@pytest.mark.parametrize("name", list(CASES))
def test_moments_match_one_process(one_process, name):
    one = one_process(name)
    for key in ("m", "v"):
        for i, (got, want) in enumerate(zip(one.mesh[key],
                                            getattr(one, key))):
            assert rel_l2(got, want) <= MESH_RTOL, (key, i)


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_match_one_process(one_process, name):
    one = one_process(name)
    got = torch.cat([p.flatten() for p in one.mesh["params"]])
    want = torch.cat([p.flatten() for p in one.params])
    assert rel_l2(got, want) <= MESH_RTOL
    for i, (g, w) in enumerate(zip(one.mesh["params"], one.params)):
        d = (g - w).abs()
        assert int((d > 1e-6).sum()) <= max(1, d.numel() // 100), i
        assert float(d.max()) <= 2 * OPT["lr"] * STEPS, i


@pytest.mark.parametrize("name", list(CASES))
def test_first_moment_is_the_clipped_gradient(ranks, name):
    for out in ranks.outs:
        assert out[name]["m_after_one"] <= 1e-6


@pytest.mark.parametrize("name", list(CASES))
def test_rank_rows_are_the_reference_stream(ref, ranks, name):
    """Bit for bit the reference's `data.batches` at the rank's batch
    coordinate; the "model" ranks of a data row share rows under tp."""
    arch = CASES[name][0]
    jc = ref.configs.smoke_config(arch)
    for r, out in enumerate(ranks.outs):
        index, count = out[name]["shard"]
        it = ref.train_data.batches(jc, ref.train_data.DataConfig(
            batch=BATCH, seq=SEQ, seed=1, host_id=index, n_hosts=count))
        for step in range(STEPS):
            want = next(it)
            for key in ("tokens", "labels"):
                got = np.asarray(out[name][key][step], np.int32)
                assert got.shape == (BATCH // count, SEQ)
                np.testing.assert_array_equal(got, want[key])
            # a VLM's patch-embedding prefix, an encoder-decoder's frames
            assert (out[name]["embeds"] is None) == ("embeds" not in want)
            if "embeds" in want:
                got = np.asarray(out[name]["embeds"][step], np.float32)
                assert got.shape == want["embeds"].shape
                assert got.shape[0] == BATCH // count
                np.testing.assert_array_equal(got, want["embeds"])
    shards = [tuple(out[name]["shard"]) for out in ranks.outs]
    if CASES[name][4] == "tp":
        # ranks (data, model) in row-major order: the model pairs share
        assert shards == [(0, 2), (0, 2), (1, 2), (1, 2)]
        assert ranks.outs[0][name]["tokens"] == ranks.outs[1][name]["tokens"]
        assert ranks.outs[0][name]["tokens"] != ranks.outs[2][name]["tokens"]
    else:
        assert shards == [(r, 4) for r in range(4)]


@pytest.fixture(scope="module")
def per_card():
    """The per-card estimate of each case's train cell (meta, a fake
    group of four)."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, pol = case(name)
            cache[name] = dryrun.per_card_fit(cfg, pol, case_shape(),
                                              FOUR_CARD)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_per_card_estimate_is_the_ranks_arguments(ranks, per_card, name):
    est = per_card(name)["estimates"][str(BATCH)]
    assert est["moment_bytes"] > 0 and est["cache_bytes"] == 0
    for out in ranks.outs:
        assert out[name]["run_arguments"] == [est["argument_bytes"]] * 4
        assert out[name]["run_finite"]
        assert len(out[name]["run_losses"]) == 1 + dryrun.RUN_TRAIN_STEPS


@pytest.mark.parametrize("name", list(CASES))
def test_step_collectives_are_the_meta_steps(ranks, per_card, name):
    """A step's collectives equal the meta step's: the mesh runner's cold
    step by count; each step of the library's, where it runs no
    micro-batches (as the cell does not), by count and bytes."""
    est = per_card(name)["estimates"][str(BATCH)]
    assert ranks.outs[0][name]["run_ops"] == est["collective_count"]
    if CASES[name][3] > 1:
        return      # the library's steps run micro-batches; the cell not
    for out in ranks.outs:
        for ops in out[name]["ops"]:
            count, nbytes = {}, {}
            for kind, result, group in ops:
                count[kind] = count.get(kind, 0) + 1
                nbytes[kind] = nbytes.get(kind, 0) + (
                    result // group if kind == "all-gather" else
                    result * group if kind == "reduce-scatter" else result)
            assert count == {k: int(v) for k, v in
                             est["collective_count"].items()}
            assert nbytes == {k: int(v) for k, v in
                              est["collective_bytes"].items()}


#: a layer's all-gathers under tp, by arch: (the ZeRO-3 weights made whole
#: over "data": wq, wk, wv, wo and the SwiGLU's wi, wg, wo; an MoE layer's
#: are the attention's four, the experts' wi, wg, wo and the shared
#: expert's three), (the router's float32 logits gathered over "model",
#: [B / data, S, E])
TP_GATHERS_A_LAYER = {"granite-3-2b": (7, 0), "pixtral-12b": (7, 0),
                      "qwen2-moe-a2.7b": (10, 1)}
TP = [name for name, c in CASES.items() if c[4] == "tp"]


def _check_tp_gathers(ranks, name):
    """Under tp every all-gather of a step is a ZeRO-3 weight made whole
    over "data" (its bytes one of the weights' on "model"), or an MoE
    layer's router logits over "model", each twice a layer (the forward
    and the remat recompute); no other activation and no batch is
    gathered. Each weight's gradient is reduce-scattered back onto its
    shards."""
    cfg, pol = case(name)
    out = ranks.outs[0][name]
    weights = set(out["fsdp_local"])
    per_layer, logits = TP_GATHERS_A_LAYER[cfg.name]
    layer_fsdp = toptim.tree_leaves(partitioning.map_axes(
        lambda ax: "embed_fsdp" in ax,
        get_family(cfg).param_axes(cfg, pol)["layers"][0]))
    assert sum(layer_fsdp) == per_layer
    gathers = [(result, group) for kind, result, group in out["ops"][0]
               if kind == "all-gather"]
    assert all(group == 2 for _, group in gathers)
    assert sum(result in weights for result, _ in gathers) == \
        2 * per_layer * cfg.n_layers
    E = pol.expert_pad or cfg.n_experts
    rest = [result for result, _ in gathers if result not in weights]
    assert rest == [BATCH // 2 * SEQ * E * 4] * (2 * logits * cfg.n_layers)
    scatters = [k for k, _, _ in out["ops"][0] if k == "reduce-scatter"]
    assert len(scatters) >= per_layer * cfg.n_layers


def test_tp_gathers_weights_not_the_batch(ranks):
    _check_tp_gathers(ranks, "granite_tp")


@pytest.mark.parametrize("name", [n for n in TP if n != "granite_tp"])
def test_tp_gathers_each_archs_weights_and_router_logits(ranks, name):
    _check_tp_gathers(ranks, name)


@pytest.mark.parametrize("name", MOE)
def test_moe_aux_term_and_router_gradient_match_one_process(
        ranks, one_process, name):
    """The MoE layers' aux term alone (no CE loss) and its gradient into
    each layer's router on the mesh equal one process's: each "model"
    rank computes the same term from the same gathered logits, and only
    its own experts' columns carry its gradient, so that the sum of the
    ranks' partial gradients counts the term once."""
    one = one_process(name)
    for r, out in enumerate(ranks.outs):
        assert out[name]["aux"] == pytest.approx(float(one.aux["aux"]),
                                                 rel=MESH_RTOL, abs=0), r
    got, want = one.mesh["aux"]["routers"], one.aux["routers"]
    assert len(got) == len(want) == case(name)[0].n_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert rel_l2(g, w) <= MESH_RTOL, i


def test_moe_choices_drop_on_every_rank_where_capacity_is_cut(ranks):
    """At capacity factor 0.5 (C = 4 of a row's 32 choices) choices drop
    on every rank, in every layer's routes, and more than at 1.25."""
    for out in ranks.outs:
        dropped, choices = out["qwen2moe_tp_drops"]["dropped"]
        base, base_choices = out["qwen2moe_tp"]["dropped"]
        assert choices == base_choices > 0
        assert 0 < dropped < choices
        assert base < dropped


def test_moe_train_4k_resolves_to_tp():
    """`resolve`'s strategy for qwen2-moe-a2.7b train_4k on data 2 x model
    2, the one its mesh train step runs."""
    cfg = get_config("qwen2-moe-a2.7b")
    pol = resolve(cfg, FOUR_CARD, SHAPES["train_4k"].batch, "train",
                  seq=SHAPES["train_4k"].seq)
    assert pol.strategy == "tp"
    assert pol.rules["expert"] == "model" and pol.batch_axes == "data"
    tstep.check_mesh_train(cfg, pol)


DP_ZERO3 = [name for name, case in CASES.items() if case[4] == "dp_zero3"]


@pytest.mark.parametrize("name", DP_ZERO3)
def test_dp_zero3_gathers_block_weights_over_four(ranks, name):
    """Under dp_zero3 every all-gather of a step is a ZeRO-3 block weight
    made whole over ("data", "model") together, a group of 4 (its result
    the whole weight's bytes): once in the forward and, with remat, again
    in the recompute, for each micro-batch; granite's 7 a layer (wq, wk,
    wv, wo and the SwiGLU's wi, wg, wo). No activation and no batch is
    gathered. Each weight's gradient comes back onto its shard by one
    reduce-scatter over the same group of 4, once a micro-batch."""
    arch, _, remat, n_micro, _ = CASES[name]
    out = ranks.outs[0][name]
    size = out["element_size"]
    fsdp = [whole * size for is_fsdp, whole, _, _, _ in out["leaves"]
            if is_fsdp]
    if arch == "granite-3-2b":
        cfg, _ = case_setup(arch, "dp_zero3", remat)
        assert len(fsdp) == 7 * cfg.n_layers
    uses = 2 if remat != "none" else 1
    for ops in out["ops"]:
        gathers = sorted(result for kind, result, group in ops
                         if kind == "all-gather")
        assert gathers == sorted(fsdp * (n_micro * uses))
        assert all(group == 4 for kind, _, group in ops
                   if kind == "all-gather")
        scatters = sorted(result * group for kind, result, group in ops
                          if kind == "reduce-scatter")
        assert scatters == sorted(fsdp * n_micro)
        assert all(group == 4 for kind, _, group in ops
                   if kind == "reduce-scatter")
    # the mesh runner's cold step: one batch, no micro-batches
    by_group = out["run_by_group"]
    assert by_group["all-gather/4"] == uses * len(fsdp)
    assert by_group["reduce-scatter/4"] == len(fsdp)
    assert not [k for k in by_group if k.startswith(("all-gather/",
                                                      "reduce-scatter/"))
                and not k.endswith("/4")]


@pytest.mark.parametrize("name", DP_ZERO3)
def test_dp_zero3_moments_are_a_quarter_of_each_fsdp_leaf(ranks, name):
    """Under dp_zero3 each rank holds a quarter of every embed_fsdp leaf
    and of its two moments (the reference's dry run's m = v = p_shard,
    sharded over both axes), and the whole of every other leaf (the
    embedding table, the norms) and of its moments."""
    for out in ranks.outs:
        leaves = out[name]["leaves"]
        assert any(is_fsdp for is_fsdp, *_ in leaves)
        for is_fsdp, whole, local, m_local, v_local in leaves:
            assert local == m_local == v_local == (
                whole // 4 if is_fsdp else whole)


@pytest.mark.parametrize("strategy", ["dp_seq"])
def test_mesh_train_refuses_the_strategies_of_step_3b(strategy):
    cfg, pol = case_setup("granite-3-2b", strategy, "none")
    assert pol.strategy == strategy
    with pytest.raises(NotImplementedError, match="item 19b, step 3b"):
        tstep.make_train_step(cfg, pol, mesh=object())
    with pytest.raises(NotImplementedError, match="item 19b, step 3b"):
        dryrun.per_card_fit(cfg, pol, case_shape(), FOUR_CARD)


@pytest.mark.parametrize("arch,strategy,n_micro", [
    ("qwen2-moe-a2.7b", "dp_zero1", 1), ("qwen2-moe-a2.7b", "dp_zero3", 1),
    ("qwen2-moe-a2.7b", "tp", 2), ("recurrentgemma-2b", "tp", 1),
    ("xlstm-1.3b", "tp", 1)])
def test_mesh_train_refuses_the_other_families(arch, strategy, n_micro):
    """The MoE family runs under tp alone and at one micro-batch; the
    hybrid and xLSTM families not at all."""
    cfg, pol = case_setup(arch, strategy, "none")
    assert pol.strategy == strategy
    with pytest.raises(NotImplementedError, match="item 19b, step 3b"):
        tstep.make_grad_fn(cfg, pol, n_micro, mesh=object())


def test_train_on_a_mesh_refuses_a_checkpoint_dir(tmp_path):
    with pytest.raises(NotImplementedError, match="item 19b, step 5"):
        tlaunch.main(["--arch", "granite-3-2b", "--reduced", "--mesh",
                      "data=2,model=2", "--device", "cpu", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
    assert not multihost.is_initialized()


class _FakeMesh:
    """A data 2 x model 2 mesh's coordinates for one rank."""
    mesh_dim_names = ("data", "model")

    def __init__(self, d, m):
        self.coord = {"data": d, "model": m}

    def size(self, i):
        return 2

    def get_local_rank(self, name):
        return self.coord[name]


@pytest.mark.parametrize("d,m", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_batch_data_shard(d, m):
    mesh = _FakeMesh(d, m)
    assert multihost.batch_data_shard(mesh, "data") == (d, 2)
    assert multihost.batch_data_shard(mesh, ("data", "model")) == \
        (2 * d + m, 4)
    assert multihost.batch_data_shard(mesh, None) == (0, 1)


@pytest.mark.parametrize("arch", ["granite-3-2b", "pixtral-12b"])
def test_lm_remat_is_the_plain_forward(arch):
    """`remat="full"` checkpoints each block: the same loss and gradients
    as without it."""
    base = smoke_config(arch)
    batch = to_torch(next(tdata.batches(base, tdata.DataConfig(
        batch=2, seq=SEQ, seed=1))))
    got = []
    for remat in ("none", "full"):
        cfg = base.with_(remat=remat)
        pol = single_device_policy(cfg)
        params = tstep.state_for(full_params(cfg, pol)).params
        loss, _, grads = tstep.make_grad_fn(cfg, pol)(params, batch)
        got.append((loss, grads))
    assert float(got[0][0]) == float(got[1][0])
    for a, b in zip(got[0][1], got[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _logsumexp_terms(cfg, h, w, lab):
    """One chunk's (sum of nll, count, sum of lse^2) written with
    `torch.logsumexp` on the whole vocabulary, as one card computes it."""
    from repro_torch.train.loss import IGNORE, NEG_INF
    logits = (h @ w.T).float()
    logits = logits.masked_fill(torch.arange(w.shape[0]) >= cfg.vocab_size,
                                NEG_INF)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, torch.clamp(
        lab, 0, cfg.vocab_size - 1)[..., None])[..., 0]
    valid = lab != IGNORE
    zero = torch.zeros(())
    return (torch.where(valid, lse - gold, zero).sum(), valid.sum(),
            torch.where(valid, lse ** 2, zero).sum())


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-2b"])
def test_chunk_terms_off_a_mesh_are_logsumexps(arch, dtype, softcap):
    """Off a mesh the loss's one chunk code (the mesh's, every mesh step
    the identity) is `torch.logsumexp`'s in value and gradient, bit for
    bit: m is the chunk's logsumexp and exp(lse - m) is exactly 1."""
    from repro_torch.train.loss import _chunk_terms
    cfg = smoke_config(arch).with_(logit_softcap=softcap)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(2, 32, cfg.d_model, generator=gen).to(dtype)
    w = torch.randn(cfg.vocab_size + 5, cfg.d_model, generator=gen).to(dtype)
    lab = torch.randint(-1, cfg.vocab_size, (2, 32), generator=gen)
    got = []
    for terms in (functools.partial(_chunk_terms, cfg,
                                    single_device_policy(cfg)),
                  functools.partial(_logsumexp_terms, cfg)):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        nll, cnt, z = terms(hh, ww, lab)
        got.append((nll, cnt, z, *torch.autograd.grad(nll + 0.5 * z,
                                                      (hh, ww))))
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
