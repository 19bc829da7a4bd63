"""Training from the command line: AdamW steps on the synthetic token
stream, with checkpointing and resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --batch 2 --seq 4096 --steps 3 [--reduced] [--device cpu] \\
      [--ckpt-dir DIR [--ckpt-every 50] [--resume]]

The counterpart of the reference's `repro/launch/train.py`.
It trains any family of `models/registry.py` (an encoder-decoder on the
stream's frames, a VLM backbone on its patch embeddings) with
``cfg.with_(attention_impl="pallas")``, as `launch/serve.py` serves it,
so that on the card every RG-LRU layer runs the hand-written recurrence
kernel (forward, and its reverse walk in the backward) and every
attention layer the flash-attention kernel; on the CPU their plain
versions. Parameters are random, drawn from one `torch.Generator` seeded
with ``--seed`` on the training device; the batches are the reference's
synthetic stream for that seed. With no ``--device`` it runs on the CUDA
card and raises without one.

Checkpointing, with the reference's semantics (`repro/launch/train.py`):
``--ckpt-dir`` saves the training state (`ckpt.CheckpointManager`, the
reference's file format, written on a background thread) every
``--ckpt-every`` steps and once more, waited for, at the end; with
``--resume`` the run restores the latest file there (if any) and goes on
from its ``step`` up to ``--steps``. As in the reference, a resumed run
starts the batch stream again at its first batch.

On a mesh of cards, under torchrun (one card a rank, NCCL;
``--device cpu`` joins gloo ranks on the CPU):

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch granite-3-2b --mesh data=2,model=2 \
      [--strategy tp|dp_zero1|dp_zero3] --batch 16 --seq 4096 --steps 3

the policy is resolved on the mesh's axes for ``"train"`` at ``--batch``
and ``--seq`` (`sharding.policy.resolve`, as the reference's
`launch/train.py:231-236` resolves it on its mesh; ``--strategy`` forces
one), every rank draws the full parameters from ``--seed`` and keeps its
shards (`launch/dryrun.py::distribute`), the moments take their
parameters' placements, and each rank reads only its rows of the stream:
``DataConfig(host_id, n_hosts)`` from its place on the batch's mesh axes
(`multihost.batch_data_shard`; the "model" ranks of a data row read the
same rows under ``tp``; under ``dp_zero1`` and ``dp_zero3`` the batch
spans both axes, and each of the four ranks reads rows of its own).
``--batch`` is the global batch. Checkpoints copy whole leaves, so
``--ckpt-dir`` with ``--mesh`` raises (re-shard is ROADMAP.md item 19b,
step 5), and so do the strategies and families the mesh step does not
run yet (`train/step.py::check_mesh_train`, step 3b: it runs the dense,
encoder-decoder and VLM families, and the MoE family under ``tp`` at one
micro-batch, whose aux term each step prints; a VLM's and an
encoder-decoder's float32 ``embeds`` are laid out by `shard_batch` as
the tokens are). qwen2-moe-a2.7b takes ``--reduced`` on one card: its
14.3 B parameters with their moments do not fit one.
Without ``--mesh`` the
one-card path is unchanged.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import multihost
from repro_torch.launch.mesh import make_mesh, parse_axes
from repro_torch.models.registry import get_family
from repro_torch.sharding.policy import resolve, single_device_policy
from repro_torch.train import data as data_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train.step import (check_mesh_train, init_state,
                                    make_train_step, shard_batch, state_for)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, stats=None):
    """Runs the steps; returns the last step's loss. When `stats` is a dict
    it receives ``step_seconds`` and ``losses`` (one per step run, host
    clock, each step ended by a device synchronize), ``grad_norms`` and
    ``start``, the step the run began at (0, or the restored step); with
    ``--mesh`` also ``strategy`` and ``shard`` (the rank's rows: index and
    count)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", type=str, default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    ap.add_argument("--mesh", type=str, default="",
                    help="axis sizes, e.g. data=2,model=2: train on a mesh "
                         "of the process group's ranks (torchrun)")
    ap.add_argument("--strategy", type=str, default="auto",
                    choices=["auto", "tp", "dp_zero1", "dp_zero3", "dp_seq"],
                    help="with --mesh: the strategy, resolved by default")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.with_(attention_impl="pallas")
    ocfg = optim_lib.AdamWConfig(lr=args.lr, warmup_steps=10,
                                 total_steps=args.steps)
    if args.mesh:
        return _main_on_mesh(args, cfg, ocfg, stats)
    dev = resolve_device(args.device)
    pol = single_device_policy(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_state(cfg, pol, gen, ocfg)
    step_fn = make_train_step(cfg, pol, ocfg, n_micro=args.n_micro)
    start = 0

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume:
        try:
            state, meta = mgr.restore_latest(state)
            start = meta["step"]
            print(f"[train] resumed from step {start}")
        except FileNotFoundError:
            pass

    it = data_lib.batches(cfg, data_lib.DataConfig(
        batch=args.batch, seq=args.seq, seed=args.seed))
    loss = _steps(args, dev, state, step_fn, it, start, stats,
                  lambda b: b, mgr, cfg)
    print(f"[train] done: {args.steps} steps, final loss {loss:.4f}")
    return loss


def _main_on_mesh(args, cfg, ocfg, stats):
    """`main` with ``--mesh``: the steps on a mesh of the process group's
    ranks (see the module's docstring)."""
    from repro_torch.launch.dryrun import distribute, param_specs

    if args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir with --mesh: checkpoints copy whole leaves; saving "
            "and restoring shards (re-shard) is ROADMAP.md item 19b, step 5")
    joined = not multihost.is_initialized()
    multihost.initialize(device=args.device)     # the card first, or gloo
    try:
        dev = resolve_device(args.device)
        axes = parse_axes(args.mesh)
        mesh = make_mesh(axes, dev.type)
        multihost.assert_mesh_spans_processes(mesh)
        pol = resolve(cfg, axes, args.batch, "train", seq=args.seq,
                      strategy=args.strategy)
        check_mesh_train(cfg, pol, args.n_micro)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = get_family(cfg).init_params(cfg, pol, gen)
        state = state_for(distribute(params, param_specs(cfg, pol, mesh)),
                          ocfg)
        del params
        step_fn = make_train_step(cfg, pol, ocfg, n_micro=args.n_micro,
                                  mesh=mesh)
        index, count = multihost.batch_data_shard(mesh, pol.batch_axes)
        it = data_lib.batches(cfg, data_lib.DataConfig(
            batch=args.batch, seq=args.seq, seed=args.seed, host_id=index,
            n_hosts=count))
        lead = multihost.process_index() == 0
        if lead:
            print(f"[train] mesh {axes} strategy {pol.strategy}: rows "
                  f"{index} of {count} a rank", flush=True)
        loss = _steps(args, dev, state, step_fn, it, 0, stats,
                      lambda b: shard_batch(pol, mesh, b), None, cfg, lead)
        if lead:
            print(f"[train] done: {args.steps} steps, final loss "
                  f"{loss:.4f}")
        if stats is not None:
            stats.update(strategy=pol.strategy, shard=[index, count])
        return loss
    finally:
        if joined:
            multihost.shutdown()


def _steps(args, dev, state, step_fn, it, start, stats, place, mgr, cfg,
           lead=True):
    """Steps `start` .. ``args.steps`` on the stream `it` (each batch laid
    out by `place`); returns the last loss."""
    if stats is not None:
        stats.update(step_seconds=[], losses=[], grad_norms=[], aux=[],
                     start=start)
    t0 = time.time()
    loss = float("nan")
    for i in range(start, args.steps):
        # tokens and labels as integers, embeds (VLM, encdec) as float32
        batch = place({k: torch.from_numpy(v).to(
            dev, torch.float32 if k == "embeds" else torch.long)
            for k, v in next(it).items()})
        _sync(dev)
        ts = time.perf_counter()
        state, mets = step_fn(state, batch)
        loss = float(mets["loss"])          # waits for the step
        _sync(dev)
        if stats is not None:
            stats["step_seconds"].append(time.perf_counter() - ts)
            stats["losses"].append(loss)
            stats["grad_norms"].append(float(mets["grad_norm"]))
            if "aux" in mets:
                stats["aux"].append(float(mets["aux"]))
        if lead and ((i + 1) % args.log_every == 0 or i == start):
            tput = args.batch * args.seq * (i + 1 - start) / \
                (time.time() - t0)
            print(f"[train] step {i + 1:5d} loss={loss:.4f} "
                  f"lr={mets['lr']:.2e} "
                  f"gnorm={float(mets['grad_norm']):.3f} "
                  + (f"aux={float(mets['aux']):.3e} " if "aux" in mets
                     else "")
                  + f"tok/s={tput:.0f}", flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, {"arch": cfg.name})
    if mgr:
        mgr.save(args.steps, state, {"arch": cfg.name})
        mgr.wait()
    return loss


if __name__ == "__main__":
    main()
