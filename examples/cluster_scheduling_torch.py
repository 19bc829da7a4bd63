"""The paper's technique as an ML-cluster feature, on the PyTorch port:
Packet scheduling of training jobs whose initialization = compile +
checkpoint restore.

Sweeps the scale ratio for a 1024-chip cluster running a mix of
(arch x shape) job types, with chip failures and stragglers enabled, and
prints the trade-off the paper measures for HPC jobs, plus the
fault-tolerance accounting. The counterpart of
examples/cluster_scheduling.py: the same types, workload and seed give
the same table. The simulator's policy calls run on the CUDA card by
default; ``--device cpu`` runs them on the CPU.

  PYTHONPATH=src python examples/cluster_scheduling_torch.py [--device cpu]
"""
import argparse

from repro_torch.cluster import ClusterConfig, ClusterSim, JobType
from repro_torch.cluster.scheduler import workload_from_arrival_rate

# job types: initialization = measured compile+restore time per arch cell
TYPES = [
    JobType("granite-3-2b:train_4k", init_time=90.0, tp_degree=16),
    JobType("yi-6b:train_4k", init_time=150.0, tp_degree=16),
    JobType("qwen2-moe-a2.7b:train_4k", init_time=240.0, tp_degree=16),
    JobType("arctic-480b:eval", init_time=600.0, tp_degree=64),
]

JOBS = 300
HORIZON = 6 * 3600.0
MEAN_WORK = 64 * 900.0          # chip-seconds per job
KS = (0.25, 0.5, 1, 2, 4, 8, 16, 64)


def run(k: float, device=None, jobs: int = JOBS) -> dict:
    """The metrics of the example's cluster at scale ratio `k`."""
    sim = ClusterSim(TYPES, ClusterConfig(
        n_chips=1024, scale_ratio=k, ckpt_period=300.0,
        mtbf_chip_hours=200.0, straggler_prob=0.03, seed=7), device=device)
    for j in workload_from_arrival_rate(TYPES, jobs, HORIZON, MEAN_WORK,
                                        seed=7):
        sim.submit(j)
    m = sim.run()
    if m["unfinished"]:
        raise RuntimeError(f"k={k}: {m['unfinished']} jobs left unfinished")
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    ap.add_argument("--jobs", type=int, default=JOBS)
    args = ap.parse_args(argv)
    print(f"{'k':>6} | {'avg wait':>9} {'med wait':>9} {'groups':>6} "
          f"{'full util':>9} {'useful':>7} {'fails':>5} {'lost chip-h':>11}")
    for k in KS:
        m = run(k, args.device, args.jobs)
        print(f"{k:6.2f} | {m['avg_wait']:9.1f} {m['med_wait']:9.1f} "
              f"{m['groups']:6d} {m['full_util']:9.3f} "
              f"{m['useful_util']:7.3f} {m['failures']:5d} "
              f"{m['lost_chip_seconds'] / 3600:11.1f}")
    print("\nsame trade-off as the paper's Figs 5/11: larger k amortizes "
          "compile/restore\n(useful fraction up) but concentrates jobs on "
          "fewer chips (queue time at low k\nexplodes when init dominates; "
          "full utilization falls as k grows).")


if __name__ == "__main__":
    main()
