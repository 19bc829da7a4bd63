"""PyTorch/CUDA port of the Packet group-scheduling DES (`repro`).

The JAX package `repro` is the untouched reference; this package mirrors
its layout (`core/des.py`, `core/sweep.py`, `kernels/packet_step/...`) so
every counterpart is found under the same name: the DES engines
(`simulate_packet`, `simulate_packet_scan`, `simulate_packet_scan_lanes`,
`simulate_packet_reference`, `simulate_packet_host`) and the grid sweep
(`run_packet_grid`) are exported by `repro_torch.core`. It imports `torch` and
`numpy` only. The hand-written CUDA kernels live under `csrc/` and are
built with `nvcc` at first launch, never at import.

Every entry point takes ``device=None``, which means the card:
`resolve_device(None)` raises when CUDA is unavailable. Only an explicit
``device="cpu"`` runs on the CPU (plain PyTorch versions of the kernels).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
