"""Blocked online-softmax attention: `ref.py` (plain PyTorch version),
`kernel.py` (build + binding of `repro_torch/csrc/flash_attention.cu`),
`ops.py` (the public wrapper `flash_attention`)."""
