"""Checkpoint data movement as recorded CommPrograms.

The counterpart of ``repro.checkpoint.reshard``. PID-Comm's claim is that
the eight collective patterns are a sufficient vocabulary for any cross-PE
data movement (PAPER.md §IV); checkpoint traffic is such movement, so it
goes through the program layer rather than around it:

* **Save** records ONE program of rooted ``gather`` collectives per
  checkpoint section (§IV-B3: the host is the root). Its structural
  fingerprint is stable across steps -- same leaves, same shapes -- so it
  lowers once and every later save hits the cube's lower cache.
* **Restore** records one program of rooted ``scatter`` collectives per
  section, each op carrying the leaf's full target spec (``spec=``). The
  program is planned under the installed profile, and its CommEvents carry
  ``program_id`` provenance into any live ``CommTrace``.

A cube tensor carries no sharding, so the gather takes each leaf's spec
beside it. A leaf may be compact (size 1 on the cube dims its spec does
not name: the trainer's masters and moments, ``models.params.trainable``)
or hold fewer axes than the cube (the optimizer's 0-d step counter, a
value every PE holds): the gather reads it through a stride-0 view of the
full cube, never a copy.

``topo`` arguments accept a :class:`~repro_torch.models.topology.Topology`
or a bare :class:`~repro_torch.core.hypercube.Hypercube`.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.layout import flatten


def _cube(topo):
    return getattr(topo, "cube", topo)


def cube_view(leaf: torch.Tensor, cube) -> torch.Tensor:
    """``leaf`` over the whole cube ``(*cube.dim_sizes, *payload)`` as a
    stride-0 view: a compact leaf's size-1 cube dims broadcast; a leaf
    with fewer axes than the cube is one value every PE holds."""
    c = cube.ndim
    payload = tuple(leaf.shape) if leaf.dim() < c else tuple(leaf.shape[c:])
    return leaf.expand(cube.dim_sizes + payload)


def gather_program(topo, leaves: Sequence[torch.Tensor],
                   specs: Sequence[tuple], *, name: str):
    """Record one rooted-gather program over all cube dims: one ``gather``
    op per leaf under its spec, inputs in leaf order (each leaf's
    ``cube_view``), outputs the global host tensors."""
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves vs {len(specs)} specs")
    cube = _cube(topo)
    comm = cube.comm(cube.dim_names)
    prog = cube.program(name=name)
    with prog:
        ins = [prog.input(cube_view(leaf, cube)) for leaf in leaves]
        prog.output(*[comm.gather(v, spec=tuple(s))
                      for v, s in zip(ins, specs)])
    return prog


def scatter_program(topo, host_leaves: Sequence[Any],
                    specs: Sequence[tuple], *, name: str, device):
    """Record one rooted-scatter program: one ``scatter`` op per leaf,
    each carrying that leaf's full target spec, placing on ``device``."""
    if len(host_leaves) != len(specs):
        raise ValueError(
            f"{len(host_leaves)} leaves vs {len(specs)} placement specs")
    cube = _cube(topo)
    comm = cube.comm(cube.dim_names)
    prog = cube.program(name=name)
    with prog:
        ins = [prog.input(a) for a in host_leaves]
        prog.output(*[comm.scatter(v, spec=tuple(s), device=device)
                      for v, s in zip(ins, specs)])
    return prog


def _as_tuple(out, n: int) -> tuple:
    return (out,) if n == 1 else tuple(out)


def gather_to_host(topo, leaves: Sequence[torch.Tensor],
                   specs: Sequence[tuple], *,
                   name: str = "ckpt-gather") -> list[torch.Tensor]:
    """Record + run the rooted-gather program for ``leaves`` -> global CPU
    tensors (copies: an in-place update of a leaf after this returns does
    not reach them)."""
    if not leaves:
        return []
    cube = _cube(topo)
    prog = gather_program(topo, leaves, specs, name=name)
    out = prog.execute(*[cube_view(leaf, cube) for leaf in leaves])
    return list(_as_tuple(out, len(leaves)))


def scatter_to_cube(topo, host_leaves: Sequence[Any],
                    specs: Sequence[tuple], *, name: str = "ckpt-scatter",
                    device=None) -> list[torch.Tensor]:
    """Record + run the rooted-scatter program: host arrays -> cube tensors
    on ``device`` (CUDA unless the CPU is asked for) under each leaf's
    target spec."""
    if not host_leaves:
        return []
    dev = str(resolve_device(device))
    prog = scatter_program(topo, host_leaves, specs, name=name, device=dev)
    out = prog.execute(*host_leaves)
    return list(_as_tuple(out, len(host_leaves)))


def flatten_specs(specs, n: int) -> list[tuple]:
    """The leaves of a spec tree (nested dicts of spec tuples) in flat
    order; ``n`` is the value tree's leaf count, checked."""
    flat = [tuple(s) for _, s in flatten(specs)]
    if len(flat) != n:
        raise ValueError(
            f"spec tree has {len(flat)} leaves, value tree has {n}")
    return flat


__all__ = [
    "cube_view", "flatten_specs", "gather_program", "gather_to_host",
    "scatter_program", "scatter_to_cube",
]
