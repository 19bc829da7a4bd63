"""Training with the PyTorch/CUDA port: a few AdamW steps of the reduced
recurrentgemma-2b (RG-LRU recurrent blocks + local attention) and
granite-3-2b on the synthetic token stream.

Runs through the training entry point, `repro_torch.launch.train.main`:
on the card every recurrent layer runs the hand-written CUDA RG-LRU kernel
(forward, and its reverse walk in the backward) and every attention layer
the flash-attention kernel. Needs one CUDA device and `nvcc` (the kernels
are built at first use); pass `--cpu` to run their plain PyTorch versions
on the CPU instead.

  PYTHONPATH=src python examples/train_lm_torch.py [--cpu]
"""
import sys

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rglru_scan.ops import lru_forward, lru_reverse
from repro_torch.launch import train


def demo(arch: str, cpu: bool):
    counts = (lru_forward.launches, lru_reverse.launches,
              flash_attention.launches)
    train.main(["--arch", arch, "--reduced", "--batch", "4", "--seq", "64",
                "--steps", "20", "--log-every", "5"]
               + (["--device", "cpu"] if cpu else []))
    fwd, rev, attn = (now - then for now, then in zip(
        (lru_forward.launches, lru_reverse.launches,
         flash_attention.launches), counts))
    print(f"  {arch}: kernel launches: RG-LRU {fwd} forward / {rev} "
          f"reverse, attention {attn}")


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv[1:]
    print(f"training on {'the CPU' if cpu else 'the CUDA card'}:")
    demo("recurrentgemma-2b", cpu)
    demo("granite-3-2b", cpu)
