"""Communicator-centric collective API over an in-process PE cube
(PID-Comm §IV, Table II).

The counterpart of ``repro.core.comm``. A tensor on the cube carries the
cube's leading axes ``(*cube.dim_sizes, *payload)``, and a collective over a
dim selection is a data movement across those leading axes on one device:
one independent instance per cube slice (§IV-B3), group members linearized
cube-major over the selected dims (the ``lax.axis_index`` order). Payload
axis arguments (``axis``) are payload-relative, exactly the per-shard axis
numbers of the JAX package.

Every executable flow is a registered algorithm, and each Table II stage is
a distinct data movement:

  naive   the replicated ``(G, G, ...)`` host buffer (every member receives
          every member's full payload), then a source-by-source sequential
          combine (or, for all_gather, a masked sum of G full-size buffers;
          for all_to_all, a per-word gather from the flattened buffer);
  pr      the same replicated buffer, reduced vertically over the stacked
          source axis in one op (or reordered by one move of the block axis;
          for all_to_all, the sources first pre-arrange their blocks on the
          reorder kernel, then each member takes one slice of the buffer);
  im/cm   the direct reduction or concatenation over the group; the
          all_to_all ``im`` is a (G-1)-step ladder of one block per step,
          and its ``cm`` is one launch of the reorder kernel
          (``repro_torch.kernels.reorder``) over the stored cube tensor:
          in the cube layout an all_to_all over a group, across all its
          instances, is one permutation of contiguous blocks. Both reorder
          launches go through ``TileSwizzle``: their gradient is the same
          kernel with the inverse permutation.

``algorithm="auto"`` dispatches the planner's pick (priced from an
installed measured profile, ``repro_torch.tuning``, where there is one);
the pick is cached per (primitive, request, payload bytes, op, installed
profile) on the communicator, so eager decode loops do not re-plan every
step and a newly installed profile re-plans. Every dispatch appends a :class:`CommEvent`
to any active :class:`CommTrace`.

The rooted four (scatter / gather / reduce / broadcast) move data between
the host and the cube (§IV-B3, the host is the root). A cube tensor carries
no sharding, so the layout comes with the call, as in the NumPy oracles
(``repro.testing.oracles``): scatter puts chunk r of the host value along
``axis`` on member r of the group and replicates it over the instances (or
places it under a whole ``spec``); broadcast replicates it over the cube;
gather concatenates the group's blocks of instance 0 along ``axis`` on the
host (``spec=()`` gives a replicated value's single copy back), and reduce
reduces that host value over ``axis``. Their data path is stage-invariant,
so one body serves every registered stage, as in the reference.

While a :class:`repro_torch.core.program.CommProgram` records, every
primitive appends an op to it instead of dispatching.

First-class non-stage flows ride the same registry without widening Table
II (``table_ii=False``): the §IX-A ``hierarchical`` all_reduce (ICI
reduce-scatter, DCN all-reduce of the 1/|ICI| shard, ICI all-gather), the
§V-C int8 ``compressed`` DCN flow (``repro_torch.core.compress``), the
Fig. 23(a) ``ring`` / ``tree`` comparators, and the compute-fused ring
flows ``ring_fused`` / ``ag_prologue`` / ``rs_epilogue``
(``repro_torch.kernels.collective``, registered when this module is
imported). On the in-process cube a ``ppermute`` hop is a roll of the
group view along its member axis: member r receives what member r - 1
(ring) or r ^ level (tree) held.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core import planner
from repro_torch.core.hypercube import Hypercube, _spec_names
from repro_torch.kernels.reorder import ops as reorder_ops
from repro_torch.telemetry import metrics as _telemetry

# Canonical Table II stage ladder, weakest to strongest.
STAGE_ORDER = ("naive", "pr", "im", "cm")

PRIMITIVES = ("all_to_all", "reduce_scatter", "all_reduce", "all_gather",
              "scatter", "gather", "reduce", "broadcast")

# op -> (sequential combine, reduction over one axis)
_REDUCERS = {
    "add": (torch.add, lambda x, dim: torch.sum(x, dim=dim)),
    "max": (torch.maximum, lambda x, dim: torch.amax(x, dim=dim)),
    "min": (torch.minimum, lambda x, dim: torch.amin(x, dim=dim)),
}

# the all_to_all ``im`` ladder runs on groups up to this size; a larger
# group escalates to ``cm`` (``repro.core.comm._LADDER_MAX``; the port
# keeps the ladder on multi-dim groups). The planner's fused ring
# candidates drop out of the race past the same size. Tunable by
# monkeypatching.
_LADDER_MAX = 32

# planner picks that run as the registry flow of the same name
_PRICED_FLOWS = ("ring_fused", "ag_prologue", "rs_epilogue", "compressed")


# ============================================================ the registry
@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """One registered collective flow."""
    primitive: str
    name: str            # registry key ("im", "hierarchical", "ring", ...)
    stage: str           # the Table II stage this flow maps onto
    table_ii: bool       # counts toward the derived applicability table
    fn: Callable         # body: fn(comm, x, **kwargs) -> Tensor


_REGISTRY: dict[str, dict[str, AlgorithmSpec]] = {p: {} for p in PRIMITIVES}


def register_algorithm(primitive: str, name: str, *, stage: str | None = None,
                       table_ii: bool | None = None):
    """Decorator registering a collective algorithm body.

    ``stage`` defaults to ``name`` when the name is a Table II stage;
    ``table_ii`` defaults to True exactly for stage names, so extras
    (``hierarchical``, ``compressed``, ``ring``, ``tree``, the fused ring
    flows) do not widen the paper's applicability table."""
    if primitive not in _REGISTRY:
        raise ValueError(f"unknown primitive {primitive!r}")
    is_stage = name in STAGE_ORDER
    if stage is None:
        if not is_stage:
            raise ValueError(f"algorithm {name!r} needs an explicit stage=")
        stage = name
    if table_ii is None:
        table_ii = is_stage

    def deco(fn):
        if name in _REGISTRY[primitive]:
            raise ValueError(
                f"algorithm {name!r} already registered for {primitive!r}")
        _REGISTRY[primitive][name] = AlgorithmSpec(primitive, name, stage,
                                                   table_ii, fn)
        return fn

    return deco


def get_algorithm(primitive: str, name: str) -> AlgorithmSpec:
    try:
        return _REGISTRY[primitive][name]
    except KeyError:
        raise ValueError(
            f"no algorithm {name!r} registered for {primitive!r}; have "
            f"{sorted(_REGISTRY.get(primitive, ()))}") from None


def registered_algorithms(primitive: str) -> tuple[str, ...]:
    return tuple(_REGISTRY[primitive])


def applicability() -> dict[str, tuple[str, ...]]:
    """Paper Table II, derived from the registry: the ordered tuple of
    stages registered (as ``table_ii``) per primitive."""
    out = {}
    for prim, algs in _REGISTRY.items():
        stages = {a.name for a in algs.values() if a.table_ii}
        out[prim] = tuple(s for s in STAGE_ORDER if s in stages)
    return out


def resolve_stage(primitive: str, algorithm: str) -> str:
    """Resolve an algorithm request against Table II: ``pidcomm`` means the
    strongest applicable stage; an inapplicable request falls back to the
    strongest applicable stage at or below it."""
    stages = applicability()[primitive]
    if algorithm == "pidcomm":
        return stages[-1]
    if algorithm not in STAGE_ORDER:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    req = STAGE_ORDER.index(algorithm)
    best = stages[0]
    for s in stages:
        if STAGE_ORDER.index(s) <= req:
            best = s
    return best


# ======================================================== instrumentation
@dataclasses.dataclass(frozen=True)
class CommEvent:
    """One dispatched collective."""
    primitive: str
    bitmap: str                  # dim selection in paper bitmap form
    dims: tuple[str, ...]
    algorithm: str               # what the caller requested ("auto", ...)
    flow: str                    # the registry algorithm actually executed
    stage: str                   # Table II stage of that flow
    group_size: int
    num_instances: int
    payload_bytes: int           # per-PE payload (rooted: the host value)
    ici_bytes: float             # planner estimate, per PE
    dcn_bytes: float
    seconds: float | None        # unset until a measured profile prices it
    # deferred-program provenance (repro_torch.core.program): the program
    # this dispatch executed under, and the recorded op ids a fused /
    # coalesced op was rewritten from. Empty for eager dispatches.
    program_id: str | None = None
    fused_from: tuple[int, ...] = ()
    # estimate provenance: "analytic" (byte model) or "measured"
    est_source: str = "analytic"


_TRACES: list["CommTrace"] = []


class CommTrace:
    """Context manager collecting :class:`CommEvent` s from every dispatch
    (eager: one event per executed collective)."""

    def __init__(self):
        self.events: list[CommEvent] = []

    def __enter__(self) -> "CommTrace":
        _TRACES.append(self)
        return self

    def __exit__(self, *exc):
        _TRACES.remove(self)
        return False

    def record(self, event: CommEvent) -> None:
        self.events.append(event)

    def total_bytes(self) -> tuple[float, float]:
        return (sum(e.ici_bytes for e in self.events),
                sum(e.dcn_bytes for e in self.events))

    def summary(self) -> dict:
        """JSON-serializable per-(primitive, flow) aggregate."""
        by: dict[str, dict] = {}
        for e in self.events:
            d = by.setdefault(f"{e.primitive}/{e.flow}", {
                "count": 0, "stage": e.stage, "payload_bytes": 0,
                "ici_bytes": 0.0, "dcn_bytes": 0.0})
            d["count"] += 1
            d["payload_bytes"] += e.payload_bytes
            d["ici_bytes"] += e.ici_bytes
            d["dcn_bytes"] += e.dcn_bytes
        ici, dcn = self.total_bytes()
        fused = [e for e in self.events if e.fused_from]
        sources: dict[str, int] = {}
        for e in self.events:
            sources[e.est_source] = sources.get(e.est_source, 0) + 1
        return {"events": len(self.events), "ici_bytes": ici,
                "dcn_bytes": dcn, "by_flow": by, "est_sources": sources,
                "fused_events": len(fused),
                "fused_from_ops": sum(len(e.fused_from) for e in fused),
                "programs": sorted({e.program_id for e in self.events
                                    if e.program_id})}


def program_mod():
    """Deferred import of :mod:`repro_torch.core.program` (cycle: programs
    record through ``Communicator._dispatch``)."""
    from repro_torch.core import program
    return program


# ========================================================== communicator
class Communicator:
    """The PID-Comm primitives bound to one (cube, dim selection).

    Built via :meth:`repro_torch.core.hypercube.Hypercube.comm`. Inputs and
    outputs are cube tensors ``(*cube.dim_sizes, *payload)``; every result
    is a freshly materialized tensor (never a broadcast view), so callers may
    write into it.
    """

    def __init__(self, cube: Hypercube, dims):
        self.cube = cube
        self.dims: tuple[str, ...] = cube.resolve_dims(dims)
        self.bitmap = "".join(
            "1" if d in self.dims else "0" for d in cube.dim_names)
        self.group_size: int = cube.group_size(self.dims)
        self.num_instances: int = cube.num_instances(self.dims)
        self.fast_dims, self.slow_dims = cube.split_fast_slow(self.dims)
        self.group_axes = tuple(cube.dim_names.index(d) for d in self.dims)
        self.inst_axes = tuple(i for i in range(cube.ndim)
                               if i not in self.group_axes)
        self._flows: dict[tuple, tuple[str, planner.CommEstimate | None]] = {}
        # block permutations of the reorder kernel and their inverses
        # (``block_perm``)
        self._perms: dict[tuple, tuple] = {}
        # communicators over sub-selections (the hierarchical split's hops)
        self._subs: dict[tuple[str, ...], "Communicator"] = {}

    def describe(self) -> str:
        return (f"Communicator[{self.cube.describe()} dims={self.bitmap} "
                f"g={self.group_size} inst={self.num_instances}]")

    def program(self, *, name: str = ""):
        """Open a :class:`repro_torch.core.program.CommProgram` recording
        scope over this communicator's cube (any communicator of the cube
        may record into it)."""
        return program_mod().CommProgram(self.cube, name=name)

    # ------------------------------------------------------ group layout
    def group_view(self, x: torch.Tensor) -> torch.Tensor:
        """(*cube, *payload) -> (G, *instance, *payload): group axes to the
        front in cube order, flattened to member index r."""
        c = self.cube.ndim
        perm = self.group_axes + self.inst_axes + tuple(range(c, x.dim()))
        y = x.permute(perm)
        return y.reshape((self.group_size,) + y.shape[len(self.group_axes):])

    def from_group_view(self, z: torch.Tensor) -> torch.Tensor:
        """(G, *instance, *payload') -> (*cube, *payload'), materialized."""
        c = self.cube.ndim
        gshape = tuple(self.cube.dim_sizes[a] for a in self.group_axes)
        z = z.reshape(gshape + tuple(z.shape[1:]))
        perm = self.group_axes + self.inst_axes + tuple(range(c, z.dim()))
        inv = sorted(range(len(perm)), key=perm.__getitem__)
        return z.permute(inv).contiguous()

    def payload_dim(self, axis: int) -> int:
        """Index of payload ``axis`` in the group view."""
        return 1 + len(self.inst_axes) + axis

    def sub(self, dims) -> "Communicator":
        """The cached communicator over ``dims`` of the same cube."""
        key = self.cube.resolve_dims(dims)
        got = self._subs.get(key)
        if got is None:
            got = self._subs[key] = Communicator(self.cube, key)
        return got

    def axis_index(self, device) -> torch.Tensor:
        """Each PE's member index in its group, shape ``cube.dim_sizes``
        (the in-process ``lax.axis_index``)."""
        return self.cube.axis_index(self.dims, device=device)

    def ring_shift(self, x: torch.Tensor, step: int = 1) -> torch.Tensor:
        """One ``ppermute`` hop of the ring ``r -> r + step``: member r of
        every group receives what member r - step held (cube layout in and
        out)."""
        return self.from_group_view(torch.roll(self.group_view(x), step, 0))

    # ------------------------------------------------------------ dispatch
    def _resolve_flow(self, primitive: str, algorithm: str,
                      payload_bytes: int, op: str = "add"):
        """Map an algorithm request onto a registry flow name. Returns
        (flow_name, planner_estimate_or_None); cached per request and
        installed profile (a profile without a content token is not
        cached)."""
        token = planner.profile_token()
        if token is None:
            return self._resolve_flow_uncached(primitive, algorithm,
                                               payload_bytes, op)
        key = (primitive, algorithm, payload_bytes, op, token)
        got = self._flows.get(key)
        if got is None:
            got = self._flows[key] = self._resolve_flow_uncached(
                primitive, algorithm, payload_bytes, op)
        return got

    def _resolve_flow_uncached(self, primitive, algorithm, payload_bytes, op):
        if algorithm == "auto":
            est = planner.plan(self.cube, primitive, self.dims, payload_bytes)
            if est.algorithm == "naive":
                return "naive", est
            if (est.algorithm == "hierarchical" and primitive == "all_reduce"
                    and op == "add"):
                return "hierarchical", est
            if (est.algorithm in _PRICED_FLOWS
                    and est.algorithm in _REGISTRY[primitive]):
                # a measured profile priced a fused ring flow (run without
                # a consumer or tile function: a plain ring collective) or
                # the compressed flow cheapest: run it as it is
                return est.algorithm, est
            if est.algorithm != "direct":
                # the pick is not executable here (a hierarchical split of
                # a non-additive op): the trace reports the flow that runs
                est = None
            return self._escalate(primitive,
                                  resolve_stage(primitive, "pidcomm"),
                                  op), est
        if algorithm == "pidcomm" or algorithm in STAGE_ORDER:
            return self._escalate(primitive,
                                  resolve_stage(primitive, algorithm),
                                  op), None
        if algorithm in _REGISTRY[primitive]:
            return algorithm, None
        raise ValueError(
            f"unknown algorithm {algorithm!r} for {primitive!r}; expected "
            f"'auto', 'pidcomm', a stage {STAGE_ORDER}, or one of "
            f"{sorted(_REGISTRY[primitive])}")

    def _escalate(self, primitive: str, stage: str, op: str) -> str:
        """Stage-level escalations that depend on the bound group
        (``repro.core.comm._escalate``): an all_to_all ``im`` ladder past
        ``_LADDER_MAX`` members runs ``cm``; a DCN-crossing additive ``im``
        all_reduce takes the §IX-A hierarchical split."""
        if (primitive == "all_to_all" and stage == "im"
                and self.group_size > _LADDER_MAX):
            return "cm"
        if (primitive == "all_reduce" and stage == "im" and op == "add"
                and self.fast_dims and self.slow_dims):
            return "hierarchical"
        return stage

    def _dispatch(self, primitive: str, x, *, algorithm: str | None,
                  op: str = "add", _meta: tuple | None = None, **kwargs):
        alg = "auto" if algorithm is None else algorithm
        if op not in _REDUCERS:
            raise ValueError(f"unknown op {op!r}; expected {sorted(_REDUCERS)}")
        rec = program_mod().active_program()
        if rec is not None:
            # deferred mode: append an op to the recording program instead
            # of dispatching; execution re-enters here with recording
            # suspended and ``_meta`` carrying the provenance
            return rec.record_op(self, primitive, x, algorithm=alg, op=op,
                                 kwargs=kwargs)
        payload = payload_bytes(self, primitive, tuple(x.shape),
                                _itemsize(x.dtype), kwargs)
        flow, est = self._resolve_flow(primitive, alg, payload, op)
        spec = get_algorithm(primitive, flow)
        if _TRACES or _telemetry.enabled():
            if est is None:
                est = planner.estimate(
                    self.cube, primitive, self.dims, payload,
                    algorithm=planner.REQUEST_TO_PLANNER.get(flow, "direct"))
            _telemetry.inc("comm.dispatches")
            _telemetry.inc(f"comm.est_source.{est.est_source}")
        if _TRACES:
            program_id, fused_from = _meta if _meta else (None, ())
            event = CommEvent(
                primitive=primitive, bitmap=self.bitmap, dims=self.dims,
                algorithm=alg, flow=flow, stage=spec.stage,
                group_size=self.group_size,
                num_instances=self.num_instances, payload_bytes=payload,
                ici_bytes=est.ici_bytes, dcn_bytes=est.dcn_bytes,
                seconds=est.seconds, program_id=program_id,
                fused_from=tuple(fused_from), est_source=est.est_source)
            for t in _TRACES:
                t.record(event)
        if primitive in ("all_reduce", "reduce_scatter", "reduce"):
            return spec.fn(self, x, op=op, **kwargs)
        return spec.fn(self, x, **kwargs)

    def _check(self, x: torch.Tensor):
        if tuple(x.shape[:self.cube.ndim]) != self.cube.dim_sizes:
            raise ValueError(
                f"cube tensor must lead with {self.cube.dim_sizes}, got "
                f"shape {tuple(x.shape)}")

    # ---------------------------------------------------- PE<->PE primitives
    def reduce_scatter(self, x: torch.Tensor, *, axis: int, op: str = "add",
                       algorithm: str | None = None) -> torch.Tensor:
        self._check(x)
        if self.group_size == 1:
            return x
        return self._dispatch("reduce_scatter", x, algorithm=algorithm,
                              op=op, axis=axis)

    def all_gather(self, x: torch.Tensor, *, axis: int,
                   algorithm: str | None = None) -> torch.Tensor:
        self._check(x)
        if self.group_size == 1:
            return x
        return self._dispatch("all_gather", x, algorithm=algorithm, axis=axis)

    def all_reduce(self, x: torch.Tensor, *, op: str = "add",
                   algorithm: str | None = None) -> torch.Tensor:
        self._check(x)
        if self.group_size == 1:
            return x
        return self._dispatch("all_reduce", x, algorithm=algorithm, op=op)

    @property
    def crosses_dcn(self) -> bool:
        return bool(self.slow_dims)

    def all_reduce_with_error(self, x: torch.Tensor, *,
                              error: torch.Tensor | None = None,
                              block: int = 256
                              ) -> tuple[torch.Tensor, torch.Tensor]:
        """§V-C compressed (int8 DCN hop) additive all-reduce that also
        returns the local quantization error, for callers that keep an
        error-feedback buffer across steps (``runtime.trainer``).

        ``error`` is the previous step's returned error (replicated within
        the fast/ICI group, per-pod values), folded in scaled by 1/|ICI|:
        the fast-domain reduce inside the flow sums the |ICI| replicas back
        to one correction per pod.

        Always dispatches eagerly (even inside a program recording scope:
        the two-output flow has no registry body) and records a
        ``compressed`` CommEvent like the single-output registry flow."""
        from repro_torch.core import compress
        self._check(x)
        if not self.slow_dims:
            raise ValueError(
                "all_reduce_with_error needs a DCN-crossing group; "
                f"{self.dims} is entirely intra-pod")
        if error is not None:
            gf = self.cube.group_size(self.fast_dims) if self.fast_dims \
                else 1
            x = x + error / gf
        payload = payload_bytes(self, "all_reduce", tuple(x.shape),
                                _itemsize(x.dtype), {})
        if _TRACES or _telemetry.enabled():
            est = planner.estimate(self.cube, "all_reduce", self.dims,
                                   payload, algorithm="compressed",
                                   block=block)
            _telemetry.inc("comm.dispatches")
            _telemetry.inc(f"comm.est_source.{est.est_source}")
        if _TRACES:
            event = CommEvent(
                primitive="all_reduce", bitmap=self.bitmap, dims=self.dims,
                algorithm="compressed", flow="compressed", stage="cm",
                group_size=self.group_size,
                num_instances=self.num_instances, payload_bytes=payload,
                ici_bytes=est.ici_bytes, dcn_bytes=est.dcn_bytes,
                seconds=est.seconds, est_source=est.est_source)
            for t in _TRACES:
                t.record(event)
        return compress.compressed_pod_all_reduce(
            x, self.cube, self.fast_dims, self.slow_dims, block=block)

    def all_to_all(self, x: torch.Tensor, *, split_axis: int,
                   concat_axis: int,
                   algorithm: str | None = None) -> torch.Tensor:
        """Member j's output block i along ``concat_axis`` is member i's
        input block j along ``split_axis`` (the paper's transpose)."""
        self._check(x)
        npay = x.dim() - self.cube.ndim
        for name, a in (("split_axis", split_axis),
                        ("concat_axis", concat_axis)):
            if not 0 <= a < npay:
                raise ValueError(f"{name}={a} outside the {npay} payload "
                                 "axes")
        if x.shape[self.cube.ndim + split_axis] % self.group_size:
            raise ValueError(
                f"split axis {split_axis} of payload "
                f"{tuple(x.shape[self.cube.ndim:])} not divisible by "
                f"{self.group_size}")
        if self.group_size == 1:
            return x
        return self._dispatch("all_to_all", x, algorithm=algorithm,
                              split_axis=split_axis, concat_axis=concat_axis)

    def block_perm(self, move_key: tuple, x: torch.Tensor, axis: int,
                   splits: bool, move: Callable
                   ) -> tuple[torch.Tensor, int, torch.Tensor | None]:
        """The reorder kernel's permutation for ``move``, a pure data
        movement of cube tensors shaped like ``x`` (named by ``move_key``),
        computed once and cached on x's device per (move_key, shape,
        device): it moves unit indices, so every dtype shares it. Its unit is the contiguous tail of the payload below
        payload ``axis`` with, at ``axis``, one group block if the move
        ``splits`` that axis, else the whole axis. ``move`` runs once, on a
        tensor of unit indices; returns (perm int32 on the device, unit
        elements, its inverse int32 on the device or None where the move
        is not a bijection of the units)."""
        key = (move_key, tuple(x.shape), x.device)
        got = self._perms.get(key)
        if got is None:
            c = self.cube.ndim
            pay = tuple(x.shape[c:])
            k = self.group_size if splits else 1
            lead = tuple(x.shape[:c]) + pay[:axis]
            idx = torch.arange(math.prod(lead) * k).reshape(lead + (k,))
            host = move(idx).reshape(-1)
            perm = host.to(device=x.device, dtype=torch.int32)
            inv = reorder_ops.inverse_perm(host)
            if inv is not None:
                inv = inv.to(device=x.device, dtype=torch.int32)
            unit = pay[axis] // k * math.prod(pay[axis + 1:])
            got = self._perms[key] = (perm, unit, inv)
        return got

    # ------------------------------------------------- rooted (host) four
    def scatter(self, host_value, *, axis: int | None = None,
                spec: tuple | None = None, device=None,
                algorithm: str | None = None) -> torch.Tensor:
        """Host -> PEs: member r of the group gets chunk r of
        ``host_value`` along ``axis``, replicated over the instances; or,
        with ``spec`` instead, the value placed under a whole
        PartitionSpec-shaped tuple (one entry per axis: None / dim name /
        tuple of names). On ``device`` (default: the value's own, the CPU
        for a NumPy array)."""
        if (axis is None) == (spec is None):
            raise ValueError("scatter takes exactly one of axis= or spec=")
        kw = {"spec": tuple(spec)} if spec is not None else {"axis": axis}
        return self._dispatch("scatter", host_value, algorithm=algorithm,
                              device=_host_device(host_value, device), **kw)

    def broadcast(self, host_value, *, device=None,
                  algorithm: str | None = None) -> torch.Tensor:
        """Host -> PEs: replicate to every PE of the cube."""
        return self._dispatch("broadcast", host_value, algorithm=algorithm,
                              device=_host_device(host_value, device))

    def gather(self, x, *, axis: int | None = None,
               spec: tuple | None = None,
               algorithm: str | None = None) -> torch.Tensor:
        """PEs -> host: the group's blocks of instance 0 concatenated along
        payload ``axis``, or the global value of a cube tensor laid out
        under ``spec`` (``spec=()``: a replicated value's single copy), as
        a CPU tensor."""
        if (axis is None) == (spec is None):
            raise ValueError("gather takes exactly one of axis= or spec=")
        self._check(x)
        kw = {"spec": tuple(spec)} if spec is not None else {"axis": axis}
        return self._dispatch("gather", x, algorithm=algorithm, **kw)

    def reduce(self, x, *, op: str = "add", axis: int = 0,
               spec: tuple | None = None,
               algorithm: str | None = None) -> torch.Tensor:
        """PEs -> host: the gathered value (sharded along ``axis`` over the
        group, or laid out under ``spec``) reduced over ``axis``, as a CPU
        tensor."""
        self._check(x)
        kw = {"spec": tuple(spec)} if spec is not None else {}
        return self._dispatch("reduce", x, algorithm=algorithm, op=op,
                              axis=axis, **kw)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _host_device(host_value, device) -> str:
    if device is None:
        device = (host_value.device if isinstance(host_value, torch.Tensor)
                  else "cpu")
    return str(torch.device(device))


def _gather_spec(comm, npay: int, axis: int | None, spec) -> tuple:
    """The payload spec a gather / reduce assembles the host value under."""
    if spec is not None:
        return tuple(spec)
    entries = [None] * npay
    entries[axis % npay] = comm.dims
    return tuple(entries)


def host_shape(comm, shape: tuple, kwargs: dict) -> tuple:
    """Global (host) shape a gather assembles from a cube tensor of
    ``shape`` (its payload axes scaled by the PEs their spec entries
    name)."""
    pay = tuple(shape[comm.cube.ndim:])
    spec = _gather_spec(comm, len(pay), kwargs.get("axis"),
                        kwargs.get("spec"))
    spec = spec + (None,) * (len(pay) - len(spec))
    return tuple(n * math.prod(comm.cube.size(d) for d in _spec_names(e))
                 for n, e in zip(pay, spec))


def payload_bytes(comm, primitive: str, shape: tuple, itemsize: int,
                  kwargs: dict) -> int:
    """Bytes one dispatch moves per PE: the host value for the rooted four
    (scatter / broadcast take it, gather / reduce assemble it), else the
    per-PE payload of the cube tensor."""
    if primitive in ("scatter", "broadcast"):
        n = math.prod(shape)
    elif primitive in ("gather", "reduce"):
        n = math.prod(host_shape(comm, shape, kwargs))
    else:
        n = math.prod(shape[comm.cube.ndim:])
    return int(n) * itemsize


# ===================================================== algorithm bodies
def _replicated(y: torch.Tensor) -> torch.Tensor:
    """The naive/pr host buffer: every member receives every member's full
    payload -- (G_member, G_src, ...), materialized."""
    g = y.shape[0]
    return y.unsqueeze(0).expand((g,) + tuple(y.shape)).contiguous()


def _to_members(comm, full: torch.Tensor) -> torch.Tensor:
    """One group result (*instance, *payload) delivered to every member."""
    g = comm.group_size
    return comm.from_group_view(
        full.unsqueeze(0).expand((g,) + tuple(full.shape)))


def _merge_blocks(z: torch.Tensor, src_dim: int, pay_dim: int
                  ) -> torch.Tensor:
    """Concatenate the blocks stacked on ``src_dim`` along ``pay_dim``
    (indices as in ``z`` with ``src_dim`` removed), block-major."""
    z = z.movedim(src_dim, pay_dim)
    shape = tuple(z.shape)
    return z.reshape(shape[:pay_dim] + (shape[pay_dim] * shape[pay_dim + 1],)
                     + shape[pay_dim + 2:])


def _split_blocks(y: torch.Tensor, pay_dim: int, g: int) -> torch.Tensor:
    """(..., G*b, ...) at ``pay_dim`` -> blocks stacked at dim 1 of the
    group view: (G_src, G_blk, ..., b, ...)."""
    n = y.shape[pay_dim]
    if n % g:
        raise ValueError(f"payload dim of size {n} not divisible by {g}")
    shape = tuple(y.shape)
    y = y.reshape(shape[:pay_dim] + (g, n // g) + shape[pay_dim + 1:])
    return y.movedim(pay_dim, 1)


# ------------------------------------------------------- reduce_scatter
def _rs_columns(comm, x, axis):
    """Every member's column of the replicated block buffer:
    (G_member, G_src, *instance, *payload/G)."""
    y = comm.group_view(x)
    blocks = _split_blocks(y, comm.payload_dim(axis), comm.group_size)
    gathered = _replicated(blocks)             # (G_mem, G_src, G_blk, ...)
    me = torch.arange(comm.group_size, device=x.device)
    return gathered[me, :, me]                 # member m <- block m of all


@register_algorithm("reduce_scatter", "naive")
def _rs_naive(comm, x, *, axis, op):
    # horizontal, source-by-source sequential reduction
    col = _rs_columns(comm, x, axis)
    comb = _REDUCERS[op][0]
    acc = col[:, 0]
    for s in range(1, comm.group_size):
        acc = comb(acc, col[:, s])
    return comm.from_group_view(acc)


@register_algorithm("reduce_scatter", "pr")
def _rs_pr(comm, x, *, axis, op):
    # vertical (vectorized) reduction over the stacked source axis
    col = _rs_columns(comm, x, axis)
    return comm.from_group_view(_REDUCERS[op][1](col, 1))


@register_algorithm("reduce_scatter", "im")
def _rs_direct(comm, x, *, axis, op):
    # direct reduction, then member r keeps block r
    y = comm.group_view(x)
    red = _REDUCERS[op][1](y, 0).unsqueeze(0)  # (1, *inst, *payload)
    blocks = _split_blocks(red, comm.payload_dim(axis), comm.group_size)
    return comm.from_group_view(blocks[0])


# ----------------------------------------------------------- all_gather
@register_algorithm("all_gather", "naive")
def _ag_naive(comm, x, *, axis):
    # root collects then broadcasts full copies: a masked sum carrying G
    # full-size buffers, one per member, each holding only its own slot
    y = comm.group_view(x)
    g = comm.group_size
    stacked = y.new_zeros((g,) + tuple(y.shape))   # (G_member, G_slot, ...)
    me = torch.arange(g, device=x.device)
    stacked[me, me] = y
    full = stacked.sum(0)                          # (G_slot, *inst, *pay)
    return _to_members(comm, _merge_blocks(full, 0, comm.payload_dim(axis) - 1))


@register_algorithm("all_gather", "pr")
def _ag_pr(comm, x, *, axis):
    # replicated buffer, then each member reorders the stacked blocks
    gathered = _replicated(comm.group_view(x))     # (G_mem, G_src, ...)
    return comm.from_group_view(
        _merge_blocks(gathered, 1, comm.payload_dim(axis)))


@register_algorithm("all_gather", "im")
def _ag_direct(comm, x, *, axis):
    # direct concatenation in group order, delivered to every member
    y = comm.group_view(x)
    full = torch.cat(y.unbind(0), dim=comm.payload_dim(axis) - 1)
    return _to_members(comm, full)


register_algorithm("all_gather", "cm")(_ag_direct)


# ----------------------------------------------------------- all_to_all
def _a2a_blocks(comm, x, split_axis):
    """(*cube, *payload) -> the group's blocks (G_src, G_blk, *instance,
    *payload with ``split_axis`` cut to b), a view."""
    y = comm.group_view(x)
    return _split_blocks(y, comm.payload_dim(split_axis), comm.group_size)


def _a2a_out(comm, mine, concat_axis):
    """(G_member, G_src, *instance, *payload) -> each member's blocks
    concatenated in source order along ``concat_axis``, on the cube."""
    return comm.from_group_view(
        _merge_blocks(mine, 1, comm.payload_dim(concat_axis)))


def _a2a_transpose(comm, x, split_axis, concat_axis):
    """The all_to_all as views and one copy (the ``cm`` permutation's
    definition): member j <- block j of every source."""
    blocks = _a2a_blocks(comm, x, split_axis)
    return _a2a_out(comm, blocks.transpose(0, 1), concat_axis)


def _a2a_shape(comm, x, split_axis, concat_axis):
    g, c = comm.group_size, comm.cube.ndim
    shape = list(x.shape)
    shape[c + split_axis] //= g
    shape[c + concat_axis] *= g
    return tuple(shape)


@register_algorithm("all_to_all", "naive")
def _aa_naive(comm, x, *, split_axis, concat_axis):
    # replicated buffer of every source's blocks, then per-word modulation:
    # a data-dependent gather from the flattened (G_src * G_blk) buffer
    g = comm.group_size
    gathered = _replicated(_a2a_blocks(comm, x, split_axis))
    flat = gathered.reshape((g, g * g) + tuple(gathered.shape[3:]))
    me = torch.arange(g, device=x.device)
    idx = torch.arange(g, device=x.device)[None, :] * g + me[:, None]
    return _a2a_out(comm, flat[me[:, None], idx], concat_axis)


@register_algorithm("all_to_all", "pr")
def _aa_pr(comm, x, *, split_axis, concat_axis):
    # PE-assisted reordering: every source pre-arranges its blocks
    # destination-major (one reorder-kernel launch over the cube tensor),
    # then each member takes its column of the replicated buffer in one
    # slice
    blocks = _a2a_blocks(comm, x, split_axis)
    perm, unit, inv = comm.block_perm(
        ("pr", split_axis), x, split_axis, True,
        lambda idx: _a2a_blocks(comm, idx, split_axis).contiguous())
    pre = reorder_ops.tile_swizzle(x.contiguous().reshape(-1, unit), perm,
                                   inv)
    gathered = _replicated(pre.reshape(blocks.shape))  # (G_mem, G_src, ...)
    me = torch.arange(comm.group_size, device=x.device)
    return _a2a_out(comm, gathered[me, :, me], concat_axis)


@register_algorithm("all_to_all", "im")
def _aa_ladder(comm, x, *, split_axis, concat_axis):
    # (G-1)-step ladder, one destination block per step and no replicated
    # buffer: at step s member m receives block m of source (m + s) % G
    g = comm.group_size
    blocks = _a2a_blocks(comm, x, split_axis)
    me = torch.arange(g, device=x.device)
    slots = torch.stack([blocks[(me + s) % g, me] for s in range(g)], dim=1)
    idx = (me[None, :] - me[:, None]) % g         # out[j] = slot (j - m) % G
    return _a2a_out(comm, slots[me[:, None], idx], concat_axis)


@register_algorithm("all_to_all", "cm")
def _aa_swizzle(comm, x, *, split_axis, concat_axis):
    # the whole all_to_all, across all instances, as one launch of the
    # reorder kernel over the stored cube tensor
    axis = max(split_axis, concat_axis)
    perm, unit, inv = comm.block_perm(
        ("cm", split_axis, concat_axis), x, axis, axis == split_axis,
        lambda idx: _a2a_transpose(comm, idx, split_axis, concat_axis))
    out = reorder_ops.tile_swizzle(x.contiguous().reshape(-1, unit), perm,
                                   inv)
    return out.reshape(_a2a_shape(comm, x, split_axis, concat_axis))


# ----------------------------------------------------------- all_reduce
@register_algorithm("all_reduce", "naive")
def _ar_naive(comm, x, *, op):
    gathered = _replicated(comm.group_view(x))
    comb = _REDUCERS[op][0]
    acc = gathered[:, 0]
    for s in range(1, comm.group_size):
        acc = comb(acc, gathered[:, s])
    return comm.from_group_view(acc)


@register_algorithm("all_reduce", "pr")
def _ar_pr(comm, x, *, op):
    gathered = _replicated(comm.group_view(x))
    return comm.from_group_view(_REDUCERS[op][1](gathered, 1))


@register_algorithm("all_reduce", "im")
def _ar_direct(comm, x, *, op):
    # DCN-crossing additive groups are escalated to "hierarchical" by the
    # dispatcher before reaching this body
    return _to_members(comm, _REDUCERS[op][1](comm.group_view(x), 0))


def _pe_flat(comm, x, multiple: int) -> tuple[torch.Tensor, int]:
    """Each PE's payload flattened and zero-padded to a multiple of
    ``multiple``: (*cube, n_padded), and the pad."""
    c = comm.cube.ndim
    flat = x.reshape(tuple(x.shape[:c]) + (-1,))
    pad = (-flat.shape[-1]) % multiple
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, pad


@register_algorithm("all_reduce", "hierarchical", stage="im", table_ii=False)
def _ar_hierarchical(comm, x, *, op):
    """§IX-A: ICI reduce-scatter, DCN all-reduce of the 1/|ICI| shard, ICI
    all-gather. DCN bytes drop |ICI|x. Falls back to the direct flow when
    the group does not span both domains or the op is not additive."""
    fast, slow = comm.fast_dims, comm.slow_dims
    if not (fast and slow) or op != "add":
        return _ar_direct(comm, x, op=op)
    ici, dcn = comm.sub(fast), comm.sub(slow)
    flat, pad = _pe_flat(comm, x, ici.group_size)
    shard = _rs_direct(ici, flat, axis=0, op="add")
    shard = _ar_direct(dcn, shard, op="add")
    full = _ag_direct(ici, shard, axis=0)
    if pad:
        full = full[..., :-pad]
    return full.reshape(x.shape)


@register_algorithm("all_reduce", "compressed", stage="cm", table_ii=False)
def _ar_compressed(comm, x, *, op):
    """§V-C: hierarchical all-reduce whose DCN hop carries blockwise-absmax
    int8 payloads, differentiable (the backward takes the same compressed
    all-reduce: a straight-through quantizer)."""
    from repro_torch.core import compress
    if op != "add":
        raise ValueError("compressed all_reduce supports op='add' only")
    if not comm.slow_dims:
        raise ValueError(
            "compressed all_reduce needs a DCN-crossing group; "
            f"{comm.dims} is entirely intra-pod")
    return compress.compressed_all_reduce(x, comm.cube, comm.dims)


@register_algorithm("all_reduce", "ring", stage="im", table_ii=False)
def _ar_ring(comm, x, *, op):
    """Bandwidth-optimal ring (Fig. 23a comparator): G-1 reduce-scatter hops
    and G-1 all-gather hops of 1/G-size chunks of payload axis 0, in the
    reference's hop order: chunk c sums members c, c + 1, ... in turn."""
    if op != "add":
        raise ValueError("ring all_reduce supports op='add' only")
    if len(comm.dims) != 1:
        raise ValueError("ring all_reduce runs on a single dim")
    g = comm.group_size
    y = comm.group_view(x)                         # (G, *inst, n, ...)
    d = comm.payload_dim(0)
    orig_len = y.shape[d]
    pad = (-orig_len) % g
    if pad:
        widths = [0, 0] * (y.dim() - d - 1) + [0, pad]
        y = torch.nn.functional.pad(y, widths)
    chunks = _split_blocks(y, d, g)                # (G_mem, G_chunk, ...)
    me = torch.arange(g, device=x.device)
    # reduce-scatter: after g - 1 hops member m holds chunk (m + 1) % g
    cur = chunks[me, me]
    for step in range(g - 1):
        got = torch.roll(cur, 1, 0)
        cur = got + chunks[me, (me - 1 - step) % g]
    # all-gather: after s hops member m holds chunk (m + 1 - s) % g
    out = torch.zeros_like(chunks)
    out[me, (me + 1) % g] = cur
    for s in range(1, g):
        cur = torch.roll(cur, 1, 0)
        out[me, (me + 1 - s) % g] = cur
    full = _merge_blocks(out, 1, d)
    if pad:
        full = full.narrow(d, 0, orig_len)
    return comm.from_group_view(full)


@register_algorithm("all_reduce", "tree", stage="im", table_ii=False)
def _ar_tree(comm, x, *, op):
    """Recursive-doubling (hypercube-exchange) all-reduce: log2(G) steps of
    full-payload exchanges with the XOR partner -- latency-optimal,
    bandwidth-suboptimal; the two-tree comparator of Fig. 23(a)."""
    if op != "add":
        raise ValueError("tree all_reduce supports op='add' only")
    g = comm.group_size
    if g & (g - 1):
        raise ValueError("tree_all_reduce needs a power-of-two group")
    acc = comm.group_view(x)
    me = torch.arange(g, device=x.device)
    level = 1
    while level < g:
        acc = acc + acc[me ^ level]
        level <<= 1
    return comm.from_group_view(acc)


# --------------------------------------------------- rooted (host) four
# The host is the root (§IV-B3). The data path is stage-invariant -- the
# host<->device copy is the transfer whatever the stage -- so one body
# serves every registered stage, as in the reference.
def _host_tensor(host_value, device: str) -> torch.Tensor:
    t = (host_value if isinstance(host_value, torch.Tensor)
         else torch.as_tensor(np.asarray(host_value)))
    return t.to(device)


def _rooted_scatter(comm, host_value, *, device, axis=None, spec=None):
    t = _host_tensor(host_value, device)
    if spec is None:
        entries = [None] * t.dim()
        entries[axis % t.dim()] = comm.dims
        spec = tuple(entries)
    return comm.cube.to_cube(t, spec).contiguous()


def _rooted_broadcast(comm, host_value, *, device):
    return comm.cube.to_cube(_host_tensor(host_value, device), ()) \
        .contiguous()


def _assemble(comm, x, axis, spec) -> torch.Tensor:
    npay = x.dim() - comm.cube.ndim
    return comm.cube.from_cube(x, _gather_spec(comm, npay, axis, spec))


def _rooted_gather(comm, x, *, axis=None, spec=None):
    return _assemble(comm, x, axis, spec).to("cpu", copy=True).contiguous()


def _rooted_reduce(comm, x, *, op, axis, spec=None):
    full = _assemble(comm, x, axis, spec)
    # the reduction keeps the payload's dtype (torch.sum would widen ints)
    return _REDUCERS[op][1](full, axis).to(x.dtype).cpu()


for _stage_name in ("naive", "im"):
    register_algorithm("scatter", _stage_name)(_rooted_scatter)
    register_algorithm("gather", _stage_name)(_rooted_gather)
for _stage_name in ("naive", "pr", "im"):
    register_algorithm("reduce", _stage_name)(_rooted_reduce)
register_algorithm("broadcast", "naive")(_rooted_broadcast)
del _stage_name


__all__ = [
    "AlgorithmSpec", "CommEvent", "CommTrace", "Communicator",
    "PRIMITIVES", "STAGE_ORDER", "applicability", "get_algorithm",
    "register_algorithm", "registered_algorithms", "resolve_stage",
]

# registration side effect: the compute-fused ring flows (ring_fused /
# ag_prologue / rs_epilogue) live with their wrappers in
# repro_torch.kernels.collective but must be in the registry whenever this
# module is importable. Importing at the bottom keeps the cycle safe: every
# name that package takes from here is defined by now.
import repro_torch.kernels.collective  # noqa: E402,F401
