"""The port's simulation core: policy formulas, the DES engines, metrics
and the grid sweep (see `repro.core` for the reference)."""
from repro_torch.core import packet, precision
from repro_torch.core.cohort import (CohortKey, WorkloadCohort, cohort_key,
                                     group_workloads, stack_workloads)
from repro_torch.core.des import (ChaosConfig, DesResult, DesState,
                                  PackedWorkload, ScanState, chaos_is_inert,
                                  chaos_uniforms, event_budget, pack_workload,
                                  packed_from_numpy, resolve_max_requeues,
                                  resolve_ring, scan_state_from_numpy,
                                  simulate_packet, simulate_packet_host,
                                  simulate_packet_reference,
                                  simulate_packet_scan,
                                  simulate_packet_scan_lanes)
from repro_torch.core.metrics import Metrics, efficiency_metrics
from repro_torch.core.schedulers import simulate_backfill, simulate_fcfs
from repro_torch.core.sweep import (CHAOS_AXIS_FIELDS, PAPER_INIT_PROPS,
                                    PAPER_SCALE_RATIOS, PlateauResult,
                                    chaos_axis_len, chaos_lane_grid,
                                    cohort_lane_sharding, lane_padding,
                                    lane_sharding, plateau_threshold,
                                    resolve_mode,
                                    run_baselines, run_cohort_grid,
                                    run_packet_grid, run_window_oracle,
                                    sweep_plan)

__all__ = [
    "packet", "precision", "CohortKey", "WorkloadCohort", "cohort_key",
    "group_workloads", "stack_workloads", "ChaosConfig", "DesResult",
    "DesState", "PackedWorkload", "ScanState", "chaos_is_inert",
    "chaos_uniforms", "event_budget", "pack_workload", "packed_from_numpy", "resolve_max_requeues",
    "resolve_ring", "scan_state_from_numpy", "simulate_packet",
    "simulate_packet_host", "simulate_packet_reference",
    "simulate_packet_scan", "simulate_packet_scan_lanes", "Metrics",
    "efficiency_metrics", "simulate_backfill", "simulate_fcfs",
    "CHAOS_AXIS_FIELDS", "PAPER_INIT_PROPS", "PAPER_SCALE_RATIOS",
    "PlateauResult", "chaos_axis_len", "chaos_lane_grid",
    "cohort_lane_sharding", "lane_padding", "lane_sharding",
    "plateau_threshold", "resolve_mode", "run_baselines", "run_cohort_grid",
    "run_packet_grid", "run_window_oracle", "sweep_plan",
]
