"""The Packet group-formation decision: `ref.py` (plain PyTorch version),
`kernel.py` (build + binding of `repro_torch/csrc/packet_select.cu`),
`ops.py` (the public wrapper `fused_packet_select`)."""
