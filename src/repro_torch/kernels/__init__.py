"""Hand-written Hopper kernels of the port, one sub-package per kernel:
`ref.py` (plain PyTorch version), `kernel.py` (build + binding of the CUDA
source under `repro_torch/csrc/`), `ops.py` (the public wrapper); `build`
runs nvcc, `routing` picks the kernel or the plain version by device."""
