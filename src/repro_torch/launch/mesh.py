"""The production meshes' axis sizes, as the mappings `resolve` takes.

The counterpart of the reference's `repro/launch/mesh.py` (`mesh.py:18-30`)
for one card: the assignment's single pod is ``{"data": 16, "model": 16}``
(256 chips), the multi-pod mesh ``{"pod": 2, "data": 16, "model": 16}``
(512 chips), and the host mesh of smoke runs 1 x 1. `sharding.policy.
resolve` takes these mappings; the dry run resolves every cell's policy
against them. Building a device mesh over several cards
(`torch.distributed.device_mesh`) belongs to the multi-card item of
ROADMAP.md.
"""
from __future__ import annotations

SINGLE_POD: dict[str, int] = {"data": 16, "model": 16}
MULTI_POD: dict[str, int] = {"pod": 2, "data": 16, "model": 16}
HOST: dict[str, int] = {"data": 1, "model": 1}


def production_axes(*, multi_pod: bool = False) -> dict[str, int]:
    """The production mesh's axis sizes (a fresh dict)."""
    return dict(MULTI_POD if multi_pod else SINGLE_POD)


def mesh_devices(axes) -> int:
    """Number of devices of a mesh with these axis sizes."""
    n = 1
    for size in axes.values():
        n *= size
    return n
