"""Train step: microbatched gradient accumulation + AdamW + metrics.

The counterpart of the reference's `repro/train/step.py` on one card:
``make_train_step`` builds a (state, batch) -> (state, metrics) function
for every family of `models/registry.py`; a batch's ``embeds`` (a VLM
backbone's patch embeddings, an encoder-decoder's frames) go to the
forward. With ``n_micro > 1`` the
batch is split into microbatches whose float32 gradients are summed in a
Python loop (the reference's `lax.scan`), then averaged. The policy is the
single-card one (`sharding/policy.py`); the reference's mesh resolution
and the logical axes that `init_state` returns beside the state there have
no counterpart on one card. The parameters are updated in place
(`optim.apply`), with weight decay counted in the reference's stacked
layout of the family (its module's ``STACKED_KEYS``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_family
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


def make_loss_fn(cfg: ModelConfig, pol: Policy, loss_chunk: int = 512):
    family = get_family(cfg)

    def loss_fn(params, batch):
        hidden, aux = family.forward(cfg, pol, params, batch["tokens"],
                                     batch.get("embeds"))
        loss, mets = chunked_ce(cfg, pol, hidden, params["embed"],
                                batch["labels"], chunk=loss_chunk)
        return loss + aux.to(loss.dtype), mets

    return loss_fn


def make_train_step(cfg: ModelConfig, pol: Policy,
                    ocfg: Optional[optim_lib.AdamWConfig] = None,
                    n_micro: int = 1, loss_chunk: int = 512):
    """(state, batch of tensors) -> (state, metrics). The metrics are
    0-d tensors on the device (``loss``, ``grad_norm``, ``ce``,
    ``tokens``) and the host float ``lr``."""
    ocfg = ocfg or optim_lib.AdamWConfig()
    loss_fn = make_loss_fn(cfg, pol, loss_chunk)
    stacked = get_family(cfg).STACKED_KEYS

    def value_and_grad(params, batch):
        loss, mets = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, optim_lib.tree_leaves(params))
        return loss.detach(), mets, list(grads)

    def train_step(state: TrainState, batch):
        if n_micro == 1:
            loss, mets, grads = value_and_grad(state.params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} is not a multiple of n_micro "
                                 f"{n_micro}")
            micro = [{k: x[i * (B // n_micro):(i + 1) * (B // n_micro)]
                      for k, x in batch.items()} for i in range(n_micro)]
            loss, grads = 0.0, None
            for mb in micro:
                li, mets, gi = value_and_grad(state.params, mb)
                loss = loss + li
                if grads is None:
                    grads = [g.float() for g in gi]
                else:
                    for g, x in zip(grads, gi):
                        g.add_(x)
                del gi
            loss = loss / n_micro
            grads = [g / n_micro for g in grads]
        params, opt, omets = optim_lib.apply(
            ocfg, state.opt, state.params, grads,
            optim_lib.decay_mask(state.params, stacked))
        out = {"loss": loss, **omets, **mets}
        return TrainState(params=params, opt=opt), out

    return train_step
