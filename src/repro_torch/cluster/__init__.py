"""The paper's technique as an ML-cluster feature (see `repro.cluster`)."""
from repro_torch.cluster.scheduler import (ClusterConfig, ClusterSim, JobType,
                                           MLJob, slice_for)

__all__ = ["ClusterConfig", "ClusterSim", "JobType", "MLJob", "slice_for"]
