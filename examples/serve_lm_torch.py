"""Batched serving with the PyTorch/CUDA port: prefill + greedy decode.

Serves the reduced granite-3-2b (SwiGLU, RMSNorm) and starcoder2-7b (tanh
GELU, LayerNorm) through the serving entry point,
`repro_torch.launch.serve.main`: the prefill runs the hand-written CUDA
flash-attention kernel in every layer and seeds a bf16 KV cache, then the
batch decodes one token per step. Needs one CUDA device and `nvcc` (the
kernel is built at first use); pass `--cpu` to run the plain PyTorch
attention on the CPU instead.

  PYTHONPATH=src python examples/serve_lm_torch.py [--cpu]
"""
import sys

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import serve


def demo(arch: str, cpu: bool):
    launches = flash_attention.launches
    serve.main(["--arch", arch, "--reduced", "--batch", "4",
                "--prompt-len", "16", "--max-new", "24"]
               + (["--device", "cpu"] if cpu else []))
    print(f"  {arch}: {flash_attention.launches - launches} attention "
          f"kernel launches")


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv[1:]
    print(f"batched greedy serving on {'the CPU' if cpu else 'the CUDA card'}:")
    demo("granite-3-2b", cpu)
    demo("starcoder2-7b", cpu)
