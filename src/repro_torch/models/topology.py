"""Per-(architecture x workload) virtual hypercube construction.

The counterpart of ``repro.models.topology``. The JAX package re-views a
physical device mesh; here the PE count is virtual (one process, one
device), so the builders take the number of PEs (and pods) instead of a
mesh:

  dense   : (pod) x data x tp
  moe     : (pod) x data x ep x etp        (attention TP = ep*etp)
  prefill with batch < data capacity: (pod) x data x cp x tp

All model collectives go through topology-bound
:class:`repro_torch.core.comm.Communicator` handles (``topo.comm(axes)``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.comm import Communicator
from repro_torch.core.hypercube import Hypercube
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Topology:
    cube: Hypercube
    dp: tuple[str, ...]      # batch axes, e.g. ("pod", "data")
    fsdp: tuple[str, ...]    # param-shard axes, e.g. ("data",)
    tp: tuple[str, ...]      # attention/FFN tensor-parallel axes
    cp: tuple[str, ...]      # context-parallel axes (may be empty)
    ep: tuple[str, ...]      # expert-parallel axes (may be empty)
    etp: tuple[str, ...]     # per-expert TP axes (may be empty)
    _comms: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def comm(self, dims) -> Communicator:
        """The cached communicator bound to ``dims`` (axis names, a bitmap,
        or a single name)."""
        key = self.cube.resolve_dims(dims)
        got = self._comms.get(key)
        if got is None:
            got = self._comms[key] = self.cube.comm(key)
        return got

    def program(self, *, name: str = ""):
        """A CommProgram recording scope over this topology's cube: inside
        it every ``topo.comm(axes)`` primitive appends to the program."""
        return self.cube.program(name=name)

    def axis_index(self, axes, device) -> torch.Tensor:
        """Each PE's index within its group over ``axes`` (shape
        ``cube.dim_sizes``; zeros when ``axes`` is empty) -- the in-process
        ``lax.axis_index``. Cached per (axes, device)."""
        key = ("axis_index", tuple(axes), str(device))
        got = self._comms.get(key)
        if got is None:
            if axes:
                got = self.cube.axis_index(axes, device=device)
            else:
                got = torch.zeros(self.cube.dim_sizes, dtype=torch.int64,
                                  device=device)
            self._comms[key] = got
        return got

    def size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.cube.size(a) for a in axes) if axes else 1

    @property
    def sp(self) -> tuple[str, ...]:
        """Sequence-parallel axes: activations between blocks are sharded
        along sequence over cp+tp (Megatron-SP generalized)."""
        return self.cp + self.tp

    @property
    def tp_size(self) -> int:
        return self.size(self.tp)


def build_topology(cfg: ModelConfig, pes: int, *, pods: int = 1,
                   global_batch: int = 0) -> Topology:
    """The logical hypercube for this config over ``pes`` virtual PEs in
    ``pods`` pods (``repro.models.topology.build_topology``).

    ``global_batch`` (if given) bounds the data-parallel degree; leftover
    intra-pod parallelism becomes context parallelism (cp)."""
    if pes < 1 or pes % pods:
        raise ValueError(f"{pes} PEs do not split into {pods} pods")
    per_pod = pes // pods
    mp = cfg.model_parallel
    if per_pod % mp:
        raise ValueError(f"{cfg.name}: model parallel {mp} does not divide "
                         f"pod size {per_pod}")
    data = per_pod // mp
    cp = 1
    if global_batch:
        batch_per_pod = max(global_batch // pods, 1)
        if batch_per_pod < data:
            cp = data // batch_per_pod
            data = batch_per_pod

    dims: dict[str, int] = {}
    if pods > 1:
        dims["pod"] = pods
    dims["data"] = data
    if cp > 1:
        dims["cp"] = cp
    if cfg.n_experts:
        dims["ep"] = cfg.ep
        dims["etp"] = cfg.etp
        tp_axes, ep_axes, etp_axes = ("ep", "etp"), ("ep",), ("etp",)
    else:
        dims["tp"] = cfg.tp
        tp_axes, ep_axes, etp_axes = ("tp",), (), ()

    cube = Hypercube.build(dims, pods=pods)
    return Topology(
        cube=cube,
        dp=(("pod",) if pods > 1 else ()) + ("data",),
        fsdp=("data",),
        tp=tp_axes,
        cp=("cp",) if cp > 1 else (),
        ep=ep_axes,
        etp=etp_axes,
    )


def build_serve_topology(cfg: ModelConfig, pes: int, *,
                         pods: int = 1) -> Topology:
    """Decode topology (``repro.models.topology.build_serve_topology``):
    maximal model sharding, batch replicated within a pod, KV caches
    sequence-sharded over the model axes (flash-decode). The ``data`` axis
    survives with size 1 so parameter specs stay identical to training."""
    if pes < 1 or pes % pods:
        raise ValueError(f"{pes} PEs do not split into {pods} pods")
    per_pod = pes // pods
    dims: dict[str, int] = {}
    if pods > 1:
        dims["pod"] = pods
    if cfg.n_experts:
        ep = min(cfg.n_experts_padded, per_pod)
        etp = per_pod // ep
        dims.update(data=1, ep=ep, etp=etp)
        tp_axes, ep_axes, etp_axes = ("ep", "etp"), ("ep",), ("etp",)
    else:
        tp = per_pod
        if cfg.serve_tp:
            tp = min(tp, cfg.serve_tp)
        dims.update(data=per_pod // tp, tp=tp)
        tp_axes, ep_axes, etp_axes = ("tp",), (), ()

    cube = Hypercube.build(dims, pods=pods)
    return Topology(
        cube=cube,
        dp=(("pod",) if pods > 1 else ()) + ("data",),
        fsdp=("data",),
        tp=tp_axes,
        cp=(),
        ep=ep_axes,
        etp=etp_axes,
    )
