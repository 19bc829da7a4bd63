"""Training from the command line: AdamW steps on the synthetic token
stream, with checkpointing and resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --batch 2 --seq 4096 --steps 3 [--reduced] [--device cpu] \\
      [--ckpt-dir DIR [--ckpt-every 50] [--resume]]

The counterpart of the reference's `repro/launch/train.py` on one card.
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
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.sharding.policy import single_device_policy
from repro_torch.train import data as data_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train.step import init_state, make_train_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, stats=None):
    """Runs the steps; returns the last step's loss. When `stats` is a dict
    it receives ``step_seconds`` and ``losses`` (one per step run, host
    clock, each step ended by a device synchronize), ``grad_norms`` and
    ``start``, the step the run began at (0, or the restored step)."""
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.with_(attention_impl="pallas")
    pol = single_device_policy(cfg)
    ocfg = optim_lib.AdamWConfig(lr=args.lr, warmup_steps=10,
                                 total_steps=args.steps)
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
    if stats is not None:
        stats.update(step_seconds=[], losses=[], grad_norms=[], start=start)

    t0 = time.time()
    for i in range(start, args.steps):
        # tokens and labels as integers, embeds (VLM, encdec) as float32
        batch = {k: torch.from_numpy(v).to(dev, torch.float32 if
                                            k == "embeds" else torch.long)
                 for k, v in next(it).items()}
        _sync(dev)
        ts = time.perf_counter()
        state, mets = step_fn(state, batch)
        loss = float(mets["loss"])          # waits for the step
        _sync(dev)
        if stats is not None:
            stats["step_seconds"].append(time.perf_counter() - ts)
            stats["losses"].append(loss)
            stats["grad_norms"].append(float(mets["grad_norm"]))
        if (i + 1) % args.log_every == 0 or i == start:
            tput = args.batch * args.seq * (i + 1 - start) / \
                (time.time() - t0)
            print(f"[train] step {i + 1:5d} loss={loss:.4f} "
                  f"lr={mets['lr']:.2e} "
                  f"gnorm={float(mets['grad_norm']):.3f} "
                  f"tok/s={tput:.0f}", flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, {"arch": cfg.name})
    if mgr:
        mgr.save(args.steps, state, {"arch": cfg.name})
        mgr.wait()
    print(f"[train] done: {args.steps} steps, final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
