"""Multi-process bootstrap: the process group whose ranks are the devices
of the multi-card path.

The counterpart of the reference's `repro/launch/multihost.py`
(`multihost.py:27-61`). In the reference, `jax.device_count()` counts every
device across hosts once `jax.distributed.initialize` has run. In the port
the devices of the multi-card path are the ranks of the default process
group, one card a rank (`device_count`, `process_index`). Without an
initialised group the world is one rank, and every path is the one-card
path. One Python process never spreads its work over several visible
cards.

Environment (explicit mode, the reference's names):
  REPRO_COORDINATOR   host:port of process 0 (a ``tcp://`` init method)
  REPRO_NUM_PROCESSES world size
  REPRO_PROCESS_ID    this process's rank
Otherwise torchrun's MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE /
LOCAL_RANK (the ``env://`` init method), the counterpart of the
reference's pod auto-detection. A process drives card LOCAL_RANK (the rank
modulo the visible cards in explicit mode).

Run a module of the port on four cards of one host with

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.dryrun \\
        --cells granite-3-2b:prefill_32k --run --mesh data=2,model=2
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """The devices of the multi-card path: the default process group's
    world size, 1 without a group."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group, 0 without one."""
    return dist.get_rank() if is_initialized() else 0


def _topology() -> dict:
    return {"process_id": process_index(), "n_processes": device_count(),
            "local_devices": 1, "global_devices": device_count()}


def _from_environment() -> tuple[str, int, int, int]:
    """(init method, world size, rank, local rank) from REPRO_* or, without
    them, torchrun's variables."""
    coord = os.environ.get("REPRO_COORDINATOR")
    if coord:
        world = int(os.environ["REPRO_NUM_PROCESSES"])
        rank = int(os.environ["REPRO_PROCESS_ID"])
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 1
        local = int(os.environ.get("LOCAL_RANK", rank % max(1, n_cards)))
        return f"tcp://{coord}", world, rank, local
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no process group to join: set REPRO_COORDINATOR, "
            f"REPRO_NUM_PROCESSES and REPRO_PROCESS_ID, or run under "
            f"torchrun (missing {', '.join(missing)})")
    return ("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
            int(os.environ.get("LOCAL_RANK", 0)))


def initialize(timeout_s: int = 300, device=None) -> dict:
    """Join the default process group; returns the reference's topology
    facts: ``process_id``, ``n_processes``, ``local_devices`` (1: a process
    drives one card) and ``global_devices`` (the world size).

    ``device=None`` means the card: the process first takes card
    LOCAL_RANK (`torch.cuda.set_device`, so that `resolve_device(None)`
    gives every rank its own card), then joins with NCCL, and raises where
    NCCL is unavailable. ``device="cpu"`` joins with gloo, for runs on the
    CPU. A process already in a group returns its facts unchanged."""
    if is_initialized():
        return _topology()
    init_method, world, rank, local = _from_environment()
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)        # raises: no card
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this PyTorch: the "
                               "multi-card path runs on NCCL only")
        torch.cuda.set_device(local)    # before anything touches a card
        backend = "nccl"
    elif torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize takes device=None (the card) or "
                         f"'cpu', got {device!r}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return _topology()


def shutdown():
    """Leave the default process group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()


def host_data_shard() -> tuple[int, int]:
    """(process id, number of processes) for the input pipeline: each
    process generates or reads only its own slice of the global batch."""
    return process_index(), device_count()


def batch_data_shard(mesh, batch_axes) -> tuple[int, int]:
    """(shard index, shard count) of this rank's rows of the global batch
    on `mesh`, for the input pipeline (``DataConfig(host_id=index,
    n_hosts=count)``): its coordinate along the mesh axes the batch shards
    over (`Policy.batch_axes`: a name, a tuple in mesh order, or None),
    the first axis outermost, as DTensor lays out ``Shard(0)`` on several
    mesh axes; and the product of their sizes. Ranks that differ only
    along other axes hold the same rows: under ``tp`` the two "model"
    ranks of a data row. (0, 1) where the batch is not sharded.
    `host_data_shard` stays the reference's (rank, world)."""
    names = (() if batch_axes is None else (batch_axes,)
             if isinstance(batch_axes, str) else tuple(batch_axes))
    index, count = 0, 1
    for name in names:
        size = mesh.size(list(mesh.mesh_dim_names).index(name))
        index = index * size + mesh.get_local_rank(name)
        count *= size
    return index, count


def assert_mesh_spans_processes(mesh) -> None:
    """The mesh must use every device of the world (catches a mesh shape
    that disagrees with the processes launched). `mesh` is a DeviceMesh,
    or anything with the reference's ``devices.size``."""
    want = device_count()
    got = (mesh.mesh.numel() if hasattr(mesh, "mesh")
           else int(mesh.devices.size))
    if got != want:
        raise RuntimeError(
            f"mesh has {got} devices but the slice exposes {want}; "
            "slice booking and mesh shape disagree")
