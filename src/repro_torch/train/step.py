"""Train step: microbatched gradient accumulation + AdamW + metrics.

The counterpart of the reference's `repro/train/step.py`:
``make_train_step`` builds a (state, batch) -> (state, metrics) function
for every family of `models/registry.py`; a batch's ``embeds`` (a VLM
backbone's patch embeddings, an encoder-decoder's frames) go to the
forward. With ``n_micro > 1`` the batch is split into microbatches whose
float32 gradients are summed in a Python loop (the reference's
`lax.scan`), then averaged. The parameters are updated in place
(`optim.apply`), with weight decay counted in the reference's stacked
layout of the family (its module's ``STACKED_KEYS``).

On a mesh (``mesh=``: the parameters DTensors of each rank's shards,
`launch/dryrun.py::distribute`; the moments from `state_for`, on their
parameters' placements; the batch each rank's rows, `shard_batch`), the
step runs under `partitioning.mesh_context` with the policy `resolve`
gave for ``"train"``: ``tp`` (heads, MLP and vocabulary over "model",
ZeRO-3 over "data": each such weight gathered where it is used,
`Policy.at_use`, its gradient reduce-scattered), ``dp_zero1`` (the batch
over every mesh axis, parameters and moments replicated) or ``dp_zero3``
(the batch over every mesh axis as under ``dp_zero1``; each block weight
sharded over ("data", "model") together, gathered whole at use by one
all-gather over the four ranks and its gradient reduce-scattered back by
one, its moments on the same quarter; the embedding table and the norms
replicated). The kernels and the loss run
on each rank's shards; each gradient is then reduced to its parameter's
placements explicitly (`optim.reduce_to_params`) before AdamW updates the
local shards. With ``n_micro > 1`` each rank splits its own rows. The
``dp_seq`` strategy, and the families and strategies outside
`MESH_TRAIN_FAMILIES` (the dense, encoder-decoder and VLM families run
under all three; the MoE family under ``tp`` alone and at one
micro-batch, its aux loss not being linear in the rows; the hybrid and
xLSTM families not at all), raise NotImplementedError: ROADMAP.md item
19b, step 3b. An MoE model's metrics hold its aux term (``aux``; with
micro-batches, the last one's, as the others). A VLM's ``embeds`` (its
patch-embedding prefix) are the batch's rows as the tokens are;
`models/lm.py::embed_tokens` splices them in
after the vocabulary-sharded lookup is summed, and the prefix positions'
labels of -1 drop out of the loss's count on every rank.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_family
from repro_torch.sharding import partitioning
from repro_torch.sharding.policy import Policy
from repro_torch.train import optim as optim_lib
from repro_torch.train.loss import chunked_ce


class TrainState(NamedTuple):
    params: dict
    opt: optim_lib.OptState


def init_state(cfg: ModelConfig, pol: Policy, gen: torch.Generator,
               ocfg: Optional[optim_lib.AdamWConfig] = None) -> TrainState:
    """Random parameters on `gen`'s device (which need gradients) and
    zero AdamW moments."""
    ocfg = ocfg or optim_lib.AdamWConfig()
    params = get_family(cfg).init_params(cfg, pol, gen)
    return state_for(params, ocfg)


def state_for(params, ocfg: Optional[optim_lib.AdamWConfig] = None
              ) -> TrainState:
    """The training state of given parameters (e.g. carried over from the
    reference with `params_from_jax`): marks them as needing gradients."""
    for p in optim_lib.tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params,
                      opt=optim_lib.init(ocfg or optim_lib.AdamWConfig(),
                                         params))


#: the strategies whose train step runs on a mesh, and for each family
#: those it runs under; the others wait for ROADMAP.md item 19b, step 3b
MESH_TRAIN_STRATEGIES = ("tp", "dp_zero1", "dp_zero3")
MESH_TRAIN_FAMILIES = {"dense": MESH_TRAIN_STRATEGIES,
                       "encdec": MESH_TRAIN_STRATEGIES,
                       "vlm": MESH_TRAIN_STRATEGIES,
                       "moe": ("tp",)}


def check_mesh_train(cfg: ModelConfig, pol: Policy, n_micro: int = 1):
    """Raises NotImplementedError for a train step on a mesh that the port
    does not run yet: ``dp_seq``; the hybrid and xLSTM families; the MoE
    family under ``dp_zero1`` / ``dp_zero3`` (their batch spans both mesh
    axes, `models/moe.py::_moe_on_shards` takes it over one) and with
    ``n_micro > 1`` (its aux loss is not linear in the rows, and a rank's
    micro-batch is not the reference's run of global rows)."""
    if pol.strategy not in MESH_TRAIN_STRATEGIES:
        raise NotImplementedError(
            f"the {pol.strategy} train step on a mesh is not ported "
            f"(ROADMAP.md item 19b, step 3b); it runs "
            f"{', '.join(MESH_TRAIN_STRATEGIES)}")
    runs = MESH_TRAIN_FAMILIES.get(cfg.family, ())
    if not runs:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's train step on a mesh "
            f"is not ported (ROADMAP.md item 19b, step 3b); it runs "
            f"{', '.join(MESH_TRAIN_FAMILIES)}")
    if pol.strategy not in runs:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's train step on a mesh "
            f"runs under {', '.join(runs)}, not {pol.strategy} (ROADMAP.md "
            f"item 19b, step 3b(ii): its batch over both mesh axes, "
            f"models/moe.py::_moe_on_shards)")
    if cfg.family == "moe" and n_micro > 1:
        raise NotImplementedError(
            f"{cfg.name}: an MoE train step on a mesh with n_micro "
            f"{n_micro} > 1 is not ported (ROADMAP.md item 19b, step "
            f"3b(ii)): the aux loss is not linear in the rows, and a "
            f"rank's micro-batch is rows of its own shard, not the "
            f"reference's run of global rows")


def shard_batch(pol: Policy, mesh, local: dict) -> dict:
    """This rank's rows of the global batch (``DataConfig(host_id, n_hosts)
    = launch.multihost.batch_data_shard(mesh, pol.batch_axes)``: tensors
    whose leading dim is its shard) as DTensors of the global batch laid
    out on ("batch", None, ...). Nothing moves between ranks."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.multihost import batch_data_shard

    _, count = batch_data_shard(mesh, pol.batch_axes)
    out = {}
    for name, x in local.items():
        shape = (x.shape[0] * count,) + tuple(x.shape[1:])
        out[name] = DTensor.from_local(
            x, mesh, partitioning.logical_placements(
                mesh, ("batch",) + (None,) * (x.dim() - 1), pol.rules),
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return out


def _micro(batch: dict, n_micro: int, i: int) -> dict:
    """Micro-batch `i` of `n_micro`: rows of a plain batch; on a mesh,
    rows of each rank's own shard, as DTensors of the micro-batch."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, x in batch.items():
        if partitioning.is_dtensor(x):
            local = x.to_local()
            b = local.shape[0] // n_micro
            shape = (x.shape[0] // n_micro,) + tuple(x.shape[1:])
            out[name] = DTensor.from_local(
                local[i * b:(i + 1) * b], x.device_mesh, x.placements,
                run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
        else:
            b = x.shape[0] // n_micro
            out[name] = x[i * b:(i + 1) * b]
    return out


def make_loss_fn(cfg: ModelConfig, pol: Policy, loss_chunk: int = 512):
    family = get_family(cfg)

    def loss_fn(params, batch):
        hidden, aux = family.forward(cfg, pol, params, batch["tokens"],
                                     batch.get("embeds"))
        loss, mets = chunked_ce(cfg, pol, hidden, params["embed"],
                                batch["labels"], chunk=loss_chunk)
        if cfg.n_experts:
            # the MoE layers' load-balance term, as the loss adds it
            mets = dict(mets, aux=aux.detach())
        return loss + aux.to(loss.dtype), mets

    return loss_fn


def make_grad_fn(cfg: ModelConfig, pol: Policy, n_micro: int = 1,
                 loss_chunk: int = 512, mesh=None):
    """(params, batch) -> (loss, metrics, gradients in `tree_leaves`
    order): with ``n_micro > 1`` the micro-batches' float32 gradients
    summed, then averaged; on a mesh each reduced to its parameter's
    placements (`optim.reduce_to_params`). Runs under the mesh's
    `partitioning.mesh_context` where `mesh` is given."""
    if mesh is not None:
        check_mesh_train(cfg, pol, n_micro)
    loss_fn = make_loss_fn(cfg, pol, loss_chunk)

    def value_and_grad(params, batch):
        loss, mets = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, optim_lib.tree_leaves(params))
        return loss.detach(), mets, list(grads)

    def grads_of(params, batch):
        if n_micro == 1:
            loss, mets, grads = value_and_grad(params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} is not a multiple of n_micro "
                                 f"{n_micro}")
            loss, grads = 0.0, None
            for i in range(n_micro):
                li, mets, gi = value_and_grad(params,
                                              _micro(batch, n_micro, i))
                loss = loss + li
                if grads is None:
                    grads = [g.float() for g in gi]
                else:
                    for g, x in zip(grads, gi):
                        g.add_(x)
                del gi
            loss = loss / n_micro
        if mesh is not None:
            grads = optim_lib.reduce_to_params(grads, params)
        if n_micro > 1:
            grads = [g / n_micro for g in grads]
        # the loss on a mesh is replicated: each rank's whole copy
        if partitioning.is_dtensor(loss):
            loss = loss.to_local()
        return loss, mets, grads

    def grad_fn(params, batch):
        with (partitioning.mesh_context(mesh) if mesh is not None
              else contextlib.nullcontext()):
            return grads_of(params, batch)

    return grad_fn


def make_train_step(cfg: ModelConfig, pol: Policy,
                    ocfg: Optional[optim_lib.AdamWConfig] = None,
                    n_micro: int = 1, loss_chunk: int = 512, mesh=None):
    """(state, batch of tensors) -> (state, metrics). The metrics are
    0-d tensors on the device (``loss``, ``grad_norm``, ``ce``,
    ``tokens``; on a mesh each rank's whole copy) and the host float
    ``lr``. With `mesh`, the state and batch are DTensors on it (see the
    module's docstring)."""
    ocfg = ocfg or optim_lib.AdamWConfig()
    grad_fn = make_grad_fn(cfg, pol, n_micro, loss_chunk, mesh)
    stacked = get_family(cfg).STACKED_KEYS

    def train_step(state: TrainState, batch):
        loss, mets, grads = grad_fn(state.params, batch)
        # on a mesh the update runs on each leaf's local shard
        params, opt, omets = optim_lib.apply(
            ocfg, state.opt, state.params, grads,
            optim_lib.decay_mask(state.params, stacked))
        out = {"loss": loss, **omets, **mets}
        # a metric on a mesh is replicated: each rank's whole copy
        out = {k: v.to_local() if partitioning.is_dtensor(v) else v
               for k, v in out.items()}
        return TrainState(params=params, opt=opt), out

    return train_step
