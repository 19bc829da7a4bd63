from repro_torch.workload.lublin import (Workload, WorkloadParams,
                                         generate_workload, paper_workloads)
from repro_torch.workload.windows import (WindowSpec, drift_scenarios,
                                          drift_workload, iter_windows,
                                          iter_windows_batch, n_dropped,
                                          slice_window, window_bounds)

__all__ = ["Workload", "WorkloadParams", "generate_workload",
           "paper_workloads", "WindowSpec", "drift_scenarios",
           "drift_workload", "iter_windows", "iter_windows_batch",
           "n_dropped", "slice_window", "window_bounds"]
