"""Paper-experiment driver: run the Packet DES over the scale-ratio sweep.

  PYTHONPATH=src python -m repro_torch.launch.sim --workload homog0.85 \\
      --init-prop 0.05 --jobs 5000 [--device cpu]

The port of `repro/launch/sim.py`: prints the scale-ratio sweep of one
workload (paper Figs. 5-14) at one init proportion, and the plateau
threshold the paper's method hands the JMS administrator. The workload is
drawn as the reference draws it (the generator's defaults, seed
``--seed + 1`` for homogeneous flows), and the 37 lanes run as one fused
`run_packet_grid` dispatch: on the card the event-step kernel, on the CPU
(``--device cpu``) its plain version. With no ``--device`` it runs on the
CUDA card and raises without one. ``--baselines`` adds the FCFS and EASY
backfill baselines at the same init proportion (`run_baselines`: one
launch of the baselines kernel a policy on the card, its plain version on
the CPU) and prints the reference's two lines for them.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.sweep import (PAPER_SCALE_RATIOS, plateau_threshold,
                                    run_baselines, run_packet_grid)
from repro_torch.device import resolve_device
from repro_torch.workload.lublin import WorkloadParams, generate_workload


def main(argv=None):
    """Runs the sweep and prints it; returns ``(grid, PlateauResult)``, and
    with ``--baselines`` ``(grid, PlateauResult, baselines)``, the last
    `run_baselines`' ``{"backfill": Metrics, "fcfs": Metrics}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="homog0.85",
                    help="hetero|homog + load, e.g. homog0.90")
    ap.add_argument("--jobs", type=int, default=5000)
    ap.add_argument("--init-prop", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baselines", action="store_true",
                    help="also the FCFS / EASY-backfill baselines")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    homog = args.workload.startswith("homog")
    load = float(args.workload[-4:])
    wl = generate_workload(WorkloadParams(
        n_jobs=args.jobs, nodes=100 if homog else 500, load=load,
        homogeneous=homog, seed=args.seed + (1 if homog else 0)))
    print(f"[sim] workload {args.workload}: {wl.n_jobs} jobs, "
          f"calculated load {wl.calculated_load():.3f}, "
          f"M={wl.params.nodes}, device {dev}")

    grid = run_packet_grid(wl, s_props=[args.init_prop], device=dev)
    ks = np.asarray(PAPER_SCALE_RATIOS)
    aw = np.asarray(grid.avg_wait)[:, 0]
    mw = np.asarray(grid.med_wait)[:, 0]
    fu = np.asarray(grid.full_util)[:, 0]
    uu = np.asarray(grid.useful_util)[:, 0]
    print(f"{'k':>8} {'avg_wait':>10} {'med_wait':>10} "
          f"{'full_util':>9} {'useful':>7}")
    for i, k in enumerate(ks):
        print(f"{k:8.1f} {aw[i]:10.1f} {mw[i]:10.1f} {fu[i]:9.3f} "
              f"{uu[i]:7.3f}")
    thr = plateau_threshold(ks, aw)
    print(f"[sim] queue-time plateau threshold: k >= {thr.threshold} "
          f"(plateau {thr.plateau:.1f}s)")
    if not args.baselines:
        return grid, thr
    bl = run_baselines(wl, s_props=[args.init_prop], device=dev)
    for name, m in bl.items():
        print(f"[sim] baseline {name}: avg_wait="
              f"{float(np.asarray(m.avg_wait)[0]):.1f}s "
              f"useful={float(np.asarray(m.useful_util)[0]):.3f}")
    return grid, thr, bl


if __name__ == "__main__":
    main()
