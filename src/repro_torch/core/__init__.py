"""The port's simulation core: policy formulas, the DES engines, metrics
and the grid sweep (see `repro.core` for the reference)."""
from repro_torch.core import packet, precision
from repro_torch.core.des import (ChaosConfig, DesResult, DesState,
                                  PackedWorkload, ScanState, chaos_is_inert,
                                  event_budget, pack_workload,
                                  packed_from_numpy, resolve_max_requeues,
                                  resolve_ring, scan_state_from_numpy,
                                  simulate_packet, simulate_packet_host,
                                  simulate_packet_reference,
                                  simulate_packet_scan,
                                  simulate_packet_scan_lanes)
from repro_torch.core.metrics import Metrics, efficiency_metrics
from repro_torch.core.sweep import (PAPER_INIT_PROPS, PAPER_SCALE_RATIOS,
                                    PlateauResult, plateau_threshold,
                                    resolve_mode, run_packet_grid,
                                    sweep_plan)

__all__ = [
    "packet", "precision", "ChaosConfig", "DesResult", "DesState",
    "PackedWorkload", "ScanState", "chaos_is_inert", "event_budget",
    "pack_workload", "packed_from_numpy", "resolve_max_requeues",
    "resolve_ring", "scan_state_from_numpy", "simulate_packet",
    "simulate_packet_host", "simulate_packet_reference",
    "simulate_packet_scan", "simulate_packet_scan_lanes", "Metrics",
    "efficiency_metrics", "PAPER_INIT_PROPS", "PAPER_SCALE_RATIOS",
    "PlateauResult", "plateau_threshold", "resolve_mode",
    "run_packet_grid", "sweep_plan",
]
