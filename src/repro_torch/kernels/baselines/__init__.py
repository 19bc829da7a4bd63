"""The rigid baseline schedulers, FCFS and EASY backfill: `ref.py` (plain
PyTorch version, the lanes in lockstep), `kernel.py` (build + binding of
`repro_torch/csrc/baselines.cu`), `ops.py` (the public wrapper
`baselines`)."""
