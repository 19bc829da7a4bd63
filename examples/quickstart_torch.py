"""Quickstart of the PyTorch/CUDA port: the paper in ~40 lines, on the GPU.

Generates a Lublin-Feitelson workload, runs the Packet-algorithm DES over a
scale-ratio sweep with the hand-written CUDA event-step kernel (and three
cells again with `mode="seq"`, the while-loop engine), and prints
the queue-time / utilization trade-off plus the plateau threshold — the
number the paper's method hands a JMS administrator. Needs one CUDA device
and `nvcc` (the kernel is built at first use); pass `--cpu` to run the plain
PyTorch step on the CPU instead.

  PYTHONPATH=src python examples/quickstart_torch.py
"""
import sys

import numpy as np

from repro_torch.core import plateau_threshold, run_packet_grid
from repro_torch.workload.lublin import WorkloadParams, generate_workload

device = "cpu" if "--cpu" in sys.argv[1:] else None

# the paper's homogeneous under-loaded workflow, reduced to 1500 jobs
wl = generate_workload(WorkloadParams(
    n_jobs=1500, nodes=100, load=0.85, homogeneous=True, seed=1))
print(f"workload: {wl.n_jobs} jobs over {wl.horizon / 86400:.1f} days, "
      f"calculated load {wl.calculated_load():.2f}, M={wl.params.nodes}")

ks = [0.1, 0.3, 0.5, 1, 2, 4, 8, 20, 50, 200]
grid = run_packet_grid(wl, ks=ks, s_props=[0.05, 0.50], device=device)

print(f"\n{'k':>6} | {'avg wait (5%)':>13} {'med wait':>9} "
      f"{'full util':>9} {'useful':>7} | {'avg wait (50%)':>14}")
for i, k in enumerate(ks):
    print(f"{k:6.1f} | {grid.avg_wait[i, 0]:13.1f} "
          f"{grid.med_wait[i, 0]:9.1f} {grid.full_util[i, 0]:9.3f} "
          f"{grid.useful_util[i, 0]:7.3f} | {grid.avg_wait[i, 1]:14.1f}")

# the first three cells again, one per call, through the while-loop engine
# (mode="seq"; on the GPU each cell is one launch of the hand-written
# while-loop kernel): a dispatch layout, not a policy
seq = run_packet_grid(wl, ks=ks[:3], s_props=[0.05], mode="seq",
                      step_impl="torch", device=device)
assert (seq.n_groups[:, 0] == grid.n_groups[:3, 0]).all()
print(f"\nmode='seq' (while-loop engine) agrees on k = {ks[:3]}: "
      f"avg wait {[round(float(w), 1) for w in seq.avg_wait[:, 0]]}")

thr = plateau_threshold(np.asarray(ks), grid.avg_wait[:, 0])
print(f"\nadministrator recommendation: scale ratio k >= {thr.threshold} "
      f"(plateau {thr.plateau:.1f}s) reaches the "
      f"queue-time plateau;\nraising k further buys nothing (paper §8); "
      f"lowering k raises full utilization\nbut inflates queue time "
      f"(the paper's central trade-off).")
