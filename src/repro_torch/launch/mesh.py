"""The production meshes' axis sizes, and device meshes over the ranks.

The counterpart of the reference's `repro/launch/mesh.py` (`mesh.py:18-30`).
The assignment's single pod is ``{"data": 16, "model": 16}`` (256 chips),
the multi-pod mesh ``{"pod": 2, "data": 16, "model": 16}`` (512 chips),
the host mesh of smoke runs 1 x 1, and `FOUR_CARD` the cut of the
production mesh to four cards of one host, both of its axes kept.
`sharding.policy.resolve` takes these mappings; the dry run resolves every
cell's policy against one of them.

`make_mesh` builds a `torch.distributed` DeviceMesh with a mapping's axis
names and sizes over the ranks of the default process group
(`launch/multihost.py`), one card a rank; `partitioning.logical_placements`
turns logical axes into DTensor placements on it.
"""
from __future__ import annotations

from typing import Mapping

SINGLE_POD: dict[str, int] = {"data": 16, "model": 16}
MULTI_POD: dict[str, int] = {"pod": 2, "data": 16, "model": 16}
HOST: dict[str, int] = {"data": 1, "model": 1}
FOUR_CARD: dict[str, int] = {"data": 2, "model": 2}


def production_axes(*, multi_pod: bool = False) -> dict[str, int]:
    """The production mesh's axis sizes (a fresh dict)."""
    return dict(MULTI_POD if multi_pod else SINGLE_POD)


def mesh_devices(axes) -> int:
    """Number of devices of a mesh with these axis sizes."""
    n = 1
    for size in axes.values():
        n *= size
    return n


def parse_axes(text: str) -> dict[str, int]:
    """``"data=2,model=2"`` -> ``{"data": 2, "model": 2}``."""
    axes = {}
    for part in text.split(","):
        name, _, size = part.partition("=")
        if not name or not size.isdigit() or int(size) < 1:
            raise ValueError(f"mesh axes are name=size pairs, got {text!r}")
        axes[name.strip()] = int(size)
    return axes


def make_mesh(axes: Mapping[str, int], device_type: str | None = None):
    """A DeviceMesh over the default group's ranks with `axes`' names and
    sizes, in their order. ``device_type=None`` means the card ("cuda");
    "cpu" builds one for gloo ranks. Raises unless the mesh's size is the
    world size, and without an initialised group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import multihost

    if not multihost.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "launch.multihost.initialize first")
    want = multihost.device_count()
    if mesh_devices(axes) != want:
        raise RuntimeError(
            f"mesh {dict(axes)} has {mesh_devices(axes)} devices but the "
            f"process group has {want} ranks")
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"a mesh of cards needs NCCL ranks, the group "
                           f"runs {dist.get_backend()}")
    return init_device_mesh(device_type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_host_mesh(device_type: str | None = None):
    """The 1 x 1 mesh of smoke runs (axes exist, size 1): one rank."""
    return make_mesh(HOST, device_type)
