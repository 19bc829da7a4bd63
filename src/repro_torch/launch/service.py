"""Streaming-service driver: the closed-loop scale-ratio controller.

  PYTHONPATH=src python -m repro_torch.launch.service \\
      --scenario intensity_step --jobs 2000 --window-jobs 250 \\
      [--chaos] [--float64] [--device cpu]

The port of `repro/launch/service.py`, with the same flags: plays one
drift scenario (`repro_torch.workload.windows.drift_scenarios`) through
the monitor → decide → actuate loop of `repro_torch.service` and prints
the tick log plus each controller's regret scorecard. ``--chaos`` runs
the fault-aware service: a 3-cell fault-regime axis (harsh / moderate /
calm, the harsh cell playing the true environment; seed 11), the
risk-aware `FaultAwareController` beside its fault-blind foils, lost work
scored per controller. Each tick's oracle is one lane dispatch of the
event-step kernel on the card; with no ``--device`` it runs on the CUDA
card and raises without one, ``--device cpu`` runs the plain version.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.des import ChaosConfig
from repro_torch.device import resolve_device
from repro_torch.service import ServiceConfig, run_service
from repro_torch.service.driver import default_controllers
from repro_torch.workload.windows import drift_scenarios

#: the fault-regime axis of ``--chaos``: harsh, moderate, calm
SERVICE_CHAOS = dict(mtbf_chip_hours=np.array([25.0, 100.0, 800.0]),
                     ckpt_period=300.0, straggler_prob=0.1,
                     straggler_factor=np.array([4.0, 1.5, 1.5]), seed=11)


def main(argv=None):
    """Runs the service and prints its log; returns `run_service`'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="intensity_step",
                    help="steady | intensity_ramp | intensity_step | "
                         "homogeneity_ramp | homogeneity_step")
    ap.add_argument("--jobs", type=int, default=2000)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--window-jobs", type=int, default=250)
    ap.add_argument("--stride-jobs", type=int, default=None)
    ap.add_argument("--s-prop", type=float, default=0.05)
    ap.add_argument("--mode", default="auto",
                    help="oracle dispatch layout (auto|seq|chunked|fused)")
    ap.add_argument("--float64", action="store_true",
                    help="run the oracle in float64")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-aware service: sweep a 3-cell fault-regime "
                         "axis per tick, add the risk-aware controller")
    ap.add_argument("--risk-lambda", type=float, default=0.1,
                    help="wait-seconds per machine-second of expected lost "
                         "work (with --chaos; default 0.1)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    flows = drift_scenarios(n_jobs=args.jobs, nodes=args.nodes,
                            n_segments=args.segments)
    if args.scenario not in flows:
        raise SystemExit(f"unknown scenario {args.scenario!r}; "
                         f"available: {sorted(flows)}")
    wl = flows[args.scenario]
    chaos = ChaosConfig(**SERVICE_CHAOS) if args.chaos else None
    config = ServiceConfig(window_jobs=args.window_jobs,
                           stride_jobs=args.stride_jobs,
                           s_prop=args.s_prop, mode=args.mode,
                           dtype="float64" if args.float64 else "float32",
                           chaos=chaos, risk_lambda=args.risk_lambda,
                           device=dev)
    out = run_service(wl, config, default_controllers(config))

    print(f"[service] {args.scenario}: {out['n_ticks']} ticks of "
          f"{config.window_jobs} jobs over {len(wl.submit)} total "
          f"({out['config']['n_dropped_jobs']} dropped past the last "
          f"window), {len(config.ks)} candidate k's per tick on {dev}"
          + (f", {config.n_chaos_cells}-cell fault axis (env: harsh)"
             if args.chaos else ""))
    if args.chaos:
        print(f"{'tick':>4} {'offered':>8} {'best k':>7} {'fault-aware':>11} "
              f"{'hyst k':>7} {'w(harsh)':>9} {'oracle':>8}")
        for t in out["ticks"]:
            fa = t["controllers"]["fault_aware"]
            print(f"{t['tick']:>4} {t['signals']['offered_load']:>8.3f} "
                  f"{t['best_k']:>7g} {fa['realized_k']:>11g} "
                  f"{t['controllers']['hysteresis']['realized_k']:>7g} "
                  f"{fa['weights'][0]:>9.2f} {t['oracle_ms']:>6.0f}ms")
    else:
        print(f"{'tick':>4} {'offered':>8} {'best k':>7} {'plateau k':>9} "
              f"{'hyst k':>7} {'naive k':>8} {'oracle':>8}")
        for t in out["ticks"]:
            print(f"{t['tick']:>4} {t['signals']['offered_load']:>8.3f} "
                  f"{t['best_k']:>7g} {t['plateau_k']:>9g} "
                  f"{t['controllers']['hysteresis']['realized_k']:>7g} "
                  f"{t['controllers']['naive']['realized_k']:>8g} "
                  f"{t['oracle_ms']:>6.0f}ms")
    for name, s in out["controllers"].items():
        line = (f"[service] {name}: switches={s['switches']} "
                f"rel_regret_wait={s['rel_regret_wait']:.4f} "
                f"mean_regret_useful={s['mean_regret_useful']:.5f} "
                f"vs_plateau={s['mean_wait_vs_plateau']:+.2f}s/tick")
        if args.chaos:
            line += f" lost_work={s['total_lost_work']:.0f} machine-s"
        print(line)
    return out


if __name__ == "__main__":
    main()
