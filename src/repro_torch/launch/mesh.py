"""The production deployment cube.

The counterpart of ``repro.launch.mesh``. The reference's deployment is
one pod of 16 x 16 devices (data x model), or two such pods joined over
DCN. The port's cube is virtual (``Hypercube``), so the deployment is a PE
count and a pod count, which ``models.topology.build_topology`` /
``build_serve_topology`` take as they are.
"""
from __future__ import annotations

__all__ = ["mesh_name", "production_cube"]


def production_cube(multi_pod: bool = False) -> tuple[int, int]:
    """``(pes, pods)`` of the deployment: 256 PEs in one pod (data x model
    16 x 16), or 512 PEs in 2 pods over DCN."""
    return (512, 2) if multi_pod else (256, 1)


def mesh_name(multi_pod: bool = False) -> str:
    """The reference's name of the deployment mesh ("16x16", "2x16x16")."""
    return "2x16x16" if multi_pod else "16x16"
