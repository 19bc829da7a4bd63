"""The Packet DES while-loop engine: `ref.py` (plain PyTorch version, the
lanes in lockstep), `kernel.py` (build + binding of
`repro_torch/csrc/packet_while.cu`), `ops.py` (the public wrapper
`packet_while`)."""
