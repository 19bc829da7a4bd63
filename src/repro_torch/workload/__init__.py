from repro_torch.workload.lublin import (Workload, WorkloadParams,
                                         generate_workload,
                                         generate_workload_batch,
                                         group_by_statics, paper_workloads,
                                         workload_statics)
from repro_torch.workload.windows import (WindowSpec, drift_scenarios,
                                          drift_workload, iter_windows,
                                          iter_windows_batch, n_dropped,
                                          slice_window, window_bounds)

__all__ = ["Workload", "WorkloadParams", "generate_workload",
           "generate_workload_batch", "group_by_statics", "paper_workloads",
           "workload_statics", "WindowSpec", "drift_scenarios",
           "drift_workload", "iter_windows", "iter_windows_batch",
           "n_dropped", "slice_window", "window_bounds"]
