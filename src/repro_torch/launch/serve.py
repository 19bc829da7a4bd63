"""Batched serving from the command line: prefill (or prompt replay) +
greedy decode of synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --reduced --batch 4 --prompt-len 32 --max-new 16 [--device cpu]

The counterpart of the reference's `repro/launch/serve.py`, for all six
families: those of `models/lm.py` (dense, moe, vlm: a prefill), the xLSTM
(xlstm-1.3b) and hybrid (recurrentgemma-2b) ones, whose prompt is replayed
token by token, and the encoder-decoder (seamless-m4t-large-v2: an
encoder pass, then the teacher-forced replay; `serve.engine.generate`).
It serves ``cfg.with_(attention_impl="pallas")``, so that on the card a
prefill and an encoder pass run the hand-written flash-attention kernel in
every layer (on the CPU its plain version); a decode step runs no kernel.
As in the reference, it draws frontend embeddings only for encdec: the
encoder's ``[batch, prompt_len, d_model]`` frames, standard normal x 0.02
(the reference's semantics, not its bits). A VLM backbone (pixtral-12b)
serves text only from here, and its patch-embedding prefix goes through
``generate(embeds=...)``. Parameters, prompts and frames are random,
drawn in that order from one `torch.Generator` seeded with ``--seed`` on
the serving device. With no ``--device`` it runs on the CUDA card and
raises without one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_family
from repro_torch.serve.engine import generate
from repro_torch.sharding.policy import single_device_policy


def setup(arch: str, reduced: bool, batch: int, prompt_len: int, seed: int,
          device):
    """(cfg, pol, params, prompts, embeds) of one serving run: the same
    seed gives the same parameters, prompts and (encdec only, else None)
    encoder frames on the same device."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if reduced else get_config(arch)
    cfg = cfg.with_(attention_impl="pallas")
    pol = single_device_policy(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = get_family(cfg).init_params(cfg, pol, gen)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    embeds = None
    if cfg.family == "encdec":
        embeds = torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                             device=dev) * 0.02
    return cfg, pol, params, prompts, embeds


def main(argv=None, stats=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)

    cfg, pol, params, prompts, embeds = setup(
        args.arch, args.reduced, args.batch, args.prompt_len, args.seed,
        args.device)
    t0 = time.time()
    out = generate(cfg, pol, params, prompts, max_new=args.max_new,
                   embeds=embeds, stats=stats)
    dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"[serve] {cfg.name}: generated {out.shape} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s); sample: {out[0][:8].tolist()}")
    if out.shape != (args.batch, args.max_new):
        raise RuntimeError(f"generated shape {out.shape}, expected "
                           f"{(args.batch, args.max_new)}")
    if (out < 0).any() or (out >= cfg.vocab_size).any():
        raise RuntimeError("a generated token lies outside the vocabulary")
    return out


if __name__ == "__main__":
    main()
