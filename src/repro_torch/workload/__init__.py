from repro_torch.workload.lublin import (Workload, WorkloadParams,
                                         generate_workload, paper_workloads)

__all__ = ["Workload", "WorkloadParams", "generate_workload",
           "paper_workloads"]
