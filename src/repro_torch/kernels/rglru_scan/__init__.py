"""Diagonal linear recurrence (the RG-LRU's scan): `ref.py` (plain PyTorch
versions, forward and reverse), `kernel.py` (build + binding of
`repro_torch/csrc/rglru_scan.cu`), `ops.py` (the public wrappers
`lru_chunked` / `chunked_lru` and their autograd Function)."""
