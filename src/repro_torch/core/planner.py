"""Structural cost model + flow pick for ``algorithm="auto"`` dispatch, and
the joint plan of a whole CommProgram.

The counterpart of ``repro.core.planner`` (``estimate``/``plan``/
``plan_program``) for the ported primitives. It carries no link or FLOP constants: the reference's constants
describe another chip, and this port prices time only from what its own
tuner will measure on the card. Until then ``seconds`` stays unset and the
candidates are ranked by the bytes they move, DCN bytes first, then ICI
bytes. Within one domain that is the reference's ranking by seconds (both
byte counts are divided by the same link rate); across domains it agrees
too, because every candidate here is Pareto-ordered (no flow moves fewer DCN
bytes while moving more ICI bytes than another).

``plan_program`` levels a program's ops by their data dependencies and,
within a level, interleaves DCN-dominant and ICI-dominant ops (largest
first in each domain), as the reference does; with no time model its
``seconds`` and ``serial_seconds`` stay unset and ``est_source`` stays
``"analytic"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Mapping

from repro_torch.core.hypercube import Hypercube
from repro_torch.telemetry import metrics as _telemetry


@dataclasses.dataclass(frozen=True)
class CommEstimate:
    primitive: str
    algorithm: str                     # naive | hierarchical | direct
    schedule: tuple[str, ...]          # human-readable hop list
    ici_bytes: float                   # per-PE bytes over ICI
    dcn_bytes: float                   # per-PE bytes over DCN
    seconds: float | None = None       # unset until a measured profile
    stage: str = ""                    # the Table II stage this flow maps to
    est_source: str = "analytic"       # "analytic" | "measured" provenance

    def dominant(self) -> str:
        """The domain whose link bounds this op: any DCN byte makes it DCN
        (a pod boundary is the slower link by an order of magnitude on
        every system the reference models), else ICI."""
        return "dcn" if self.dcn_bytes > 0 else "ici"


# Stack of installed profiles (the reference's ``repro.tuning`` profiles):
# none is measured for this port yet, so nothing here prices time from
# one; the stack exists so the lower cache keys on the installed profile
# exactly as the reference does.
_PROFILES: list = []


def active_profile():
    """The innermost installed profile, or None."""
    return _PROFILES[-1] if _PROFILES else None


@contextlib.contextmanager
def install_profile(profile):
    """Install ``profile`` for the scope (nests; the innermost wins)."""
    _PROFILES.append(profile)
    try:
        yield profile
    finally:
        _PROFILES.remove(profile)


def _group_bytes(primitive: str, payload: float, g: int) -> float:
    """Per-PE bytes moved by the *direct* algorithm on one flat group."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    return {
        "all_to_all": payload * frac,
        "reduce_scatter": payload * frac,
        "all_gather": payload * (g - 1),   # payload = per-PE shard bytes
        "all_reduce": 2 * payload * frac,
        # rooted (host) four: the payload crosses the host link once
        "broadcast": payload,
        "scatter": payload,
        "gather": payload,
        "reduce": payload,
    }[primitive]


# compute-fused ring flows (repro_torch.kernels.collective) and the
# primitive each one is registered under; the planner races them for that
# primitive and checks explicit estimate requests against it
_FUSED_PRIMITIVE = {
    "ring_fused": "all_gather",
    "ag_prologue": "all_gather",
    "rs_epilogue": "reduce_scatter",
}


def _stage(primitive: str, algorithm: str) -> str:
    """The stage label an estimate reports: a non-Table-II registry entry
    (hierarchical, compressed, the fused ring flows) carries its own;
    ``direct`` runs the resolved ``pidcomm`` stage."""
    from repro_torch.core.comm import get_algorithm, resolve_stage
    if algorithm == "naive":
        return "naive"
    try:
        spec = get_algorithm(primitive, algorithm)
    except ValueError:
        spec = None
    if spec is not None and not spec.table_ii:
        return spec.stage
    return resolve_stage(primitive, "pidcomm")


def _direct_bytes(primitive: str, payload_bytes: float, gf: int,
                  gs: int) -> tuple[float, float]:
    ici = _group_bytes(primitive, payload_bytes, gf) if gf > 1 else 0.0
    dcn = 0.0
    if gs > 1:
        dcn = _group_bytes(
            primitive,
            payload_bytes * (gf if primitive == "all_gather" else 1), gs)
    return ici, dcn


def estimate(cube: Hypercube, primitive: str, dims, payload_bytes: float,
             algorithm: str = "pidcomm", *, dtype_bytes: int = 4,
             block: int = 256) -> CommEstimate:
    """Bytes one collective moves per PE. ``payload_bytes`` is the per-PE
    payload (all_gather: the local shard). ``algorithm``: ``naive`` (the
    replicated-intermediate host flow), ``direct`` (one flat collective over
    the group, even across pods), ``compressed`` (the §V-C split with a
    blockwise-int8 DCN hop; ``dtype_bytes``/``block`` size the compression
    ratio), a fused ring flow (``ring_fused`` / ``ag_prologue`` /
    ``rs_epilogue``: the direct flow's bytes, interleaved with compute), or
    ``pidcomm``/``hierarchical`` (the §IX-A split for an all_reduce
    spanning both domains, else direct)."""
    if algorithm in _FUSED_PRIMITIVE:
        want = _FUSED_PRIMITIVE[algorithm]
        if primitive != want:
            raise ValueError(
                f"fused algorithm {algorithm!r} is an {want!r} flow, not "
                f"{primitive!r}")
    elif algorithm not in ("pidcomm", "naive", "direct", "hierarchical",
                           "compressed"):
        raise ValueError(f"unknown planner algorithm {algorithm!r}")
    sel = cube.resolve_dims(dims)
    fast, slow = cube.split_fast_slow(sel)
    gf = math.prod(cube.size(d) for d in fast)
    gs = math.prod(cube.size(d) for d in slow)
    g = gf * gs
    if algorithm == "compressed":
        # full-precision ICI reduce-scatter, int8 all-gather of the 1/|ICI|
        # shard (+ one f32 scale per block) across pods, ICI all-gather
        ici = 2 * payload_bytes * (gf - 1) / gf if gf > 1 else 0.0
        shard = payload_bytes / gf
        dcn = (gs - 1) * (shard / dtype_bytes) * (1.0 + 4.0 / block) \
            if gs > 1 else 0.0
        sched = ((f"reduce_scatter[{'x'.join(fast)}]",) if fast else ()) + \
            ((f"all_gather-int8[{'x'.join(slow)}]",) if slow else ()) + \
            ((f"all_gather[{'x'.join(fast)}]",) if fast else ())
        return CommEstimate(primitive, "compressed", sched, ici, dcn,
                            stage="cm")
    if algorithm in _FUSED_PRIMITIVE:
        # the ring moves the direct flow's blocks, interleaved with compute:
        # only a measured time could separate it from the direct flow
        ici, dcn = _direct_bytes(primitive, payload_bytes, gf, gs)
        sched = (f"ppermute-ring[{'x'.join(sel)}]x{g - 1}·fused-compute",)
        return CommEstimate(primitive, algorithm, sched, ici, dcn,
                            stage=_stage(primitive, algorithm))
    if algorithm == "naive":
        # every PE ships its full payload to everyone
        ici = payload_bytes * (gf - 1) if gf > 1 else 0.0
        dcn = payload_bytes * (g - 1) - ici if gs > 1 else 0.0
        sched = (f"allgather-full[{'x'.join(sel)}]", "local-modulate",
                 "local-slice")
        return CommEstimate(primitive, "naive", sched, ici, dcn,
                            stage="naive")
    if (algorithm != "direct" and primitive == "all_reduce"
            and gs > 1 and gf > 1):
        ici = 2 * payload_bytes * (gf - 1) / gf
        dcn = 2 * (payload_bytes / gf) * (gs - 1) / gs
        sched = (f"reduce_scatter[{'x'.join(fast)}]",
                 f"all_reduce[{'x'.join(slow)}]",
                 f"all_gather[{'x'.join(fast)}]")
        return CommEstimate(primitive, "hierarchical", sched, ici, dcn,
                            stage=_stage(primitive, "hierarchical"))
    ici, dcn = _direct_bytes(primitive, payload_bytes, gf, gs)
    return CommEstimate(primitive, "direct", (f"{primitive}[{'x'.join(sel)}]",),
                        ici, dcn, stage=_stage(primitive, "direct"))


def plan(cube: Hypercube, primitive: str, dims, payload_bytes: float, *,
         allow_compressed: bool = False) -> CommEstimate:
    """Pick the flow with the fewest DCN bytes, then the fewest ICI bytes,
    among the naive host flow, the flat direct collective, (for a group
    spanning both domains) the hierarchical split, the fused ring flows of
    this primitive (groups up to ``comm._LADDER_MAX``) and, with
    ``allow_compressed`` (opt-in: the caller owns the accuracy contract
    that lossy compression bends), the §V-C int8 flow of a pod-crossing
    all_reduce. Ties go away from naive (where bytes cannot separate them
    the native collective runs) and away from the fused flows (their bytes
    tie direct exactly; only a measured time could price them cheaper)."""
    algs = ["naive", "direct", "pidcomm"]
    if allow_compressed and primitive == "all_reduce" \
            and cube.crosses_dcn(dims):
        algs.append("compressed")
    from repro_torch.core import comm
    if cube.group_size(cube.resolve_dims(dims)) <= comm._LADDER_MAX:
        algs += [a for a, p in _FUSED_PRIMITIVE.items() if p == primitive]
    cands = [estimate(cube, primitive, dims, payload_bytes, a) for a in algs]
    return min(cands, key=lambda e: (e.dcn_bytes, e.ici_bytes,
                                     e.algorithm == "naive",
                                     e.algorithm in _FUSED_PRIMITIVE))


# -------------------------------------------------------- program planning
@dataclasses.dataclass(frozen=True)
class ProgramOpSpec:
    """One CommProgram op as the planner sees it (shapes only)."""
    op_id: int
    primitive: str
    dims: tuple[str, ...]
    payload_bytes: float
    deps: tuple[int, ...] = ()
    algorithm: str = "auto"
    op: str = "add"                    # reducer, for escalation parity
    allow_compressed: bool = False


@dataclasses.dataclass(frozen=True)
class ProgramPlan:
    """Joint plan of a whole program: per-op estimates, an explicit
    interleaving order for independent ops, and the dependency levels.
    ``seconds`` / ``serial_seconds`` stay unset until a measured profile
    prices the ops (the reference prices them from another chip's link
    constants)."""
    estimates: Mapping[int, CommEstimate]
    order: tuple[int, ...]             # dependency-safe dispatch order
    levels: tuple[tuple[int, ...], ...]  # independent-op waves
    ici_bytes: float
    dcn_bytes: float
    seconds: float | None = None
    serial_seconds: float | None = None
    est_source: str = "analytic"


def _alternate(first, second):
    out = []
    for pair in itertools.zip_longest(first, second):
        out += [i for i in pair if i is not None]
    return out


# planner algorithm to estimate for a requested dispatch algorithm or an
# executed flow (the CommEvent estimates of comm.py); anything unlisted
# (Table II stages, ring / tree) runs a native flow, whose byte model is
# "direct"
REQUEST_TO_PLANNER = {
    "naive": "naive",
    "hierarchical": "pidcomm",
    "compressed": "compressed",
    "ring_fused": "ring_fused",
    "ag_prologue": "ag_prologue",
    "rs_epilogue": "rs_epilogue",
}


def _op_estimate(cube: Hypercube, o: ProgramOpSpec) -> CommEstimate:
    """``auto``/``pidcomm`` race the flows; ``naive`` prices the host flow,
    ``hierarchical`` the split, ``compressed`` and the fused flows their
    own models; any other stage (and ring / tree) runs a native flow,
    priced direct -- except an additive all_reduce resolving to ``im``,
    which the dispatcher escalates to the hierarchical split on a group
    spanning both domains."""
    if o.algorithm in ("auto", "pidcomm"):
        return plan(cube, o.primitive, o.dims, o.payload_bytes,
                    allow_compressed=o.allow_compressed)
    alg = REQUEST_TO_PLANNER.get(o.algorithm)
    if alg is not None:
        return estimate(cube, o.primitive, o.dims, o.payload_bytes, alg)
    alg = "direct"
    if (o.primitive == "all_reduce" and o.op == "add"
            and o.algorithm not in ("ring", "tree")):
        from repro_torch.core.comm import resolve_stage
        try:
            if resolve_stage("all_reduce", o.algorithm) == "im":
                alg = "pidcomm"
        except ValueError:
            pass
    return estimate(cube, o.primitive, o.dims, o.payload_bytes, alg)


def plan_program(cube: Hypercube, ops) -> ProgramPlan:
    """One planning pass over a whole CommProgram: estimate every op, level
    the ops by data dependency (wave l = ops whose deps all sit in waves <
    l), and order each wave so DCN-dominant and ICI-dominant ops alternate,
    the larger first within each domain, so neither link sits idle."""
    est = {o.op_id: _op_estimate(cube, o) for o in ops}
    level_of: dict[int, int] = {}
    remaining = {o.op_id: o for o in ops}
    levels: list[tuple[int, ...]] = []
    while remaining:
        wave = [oid for oid, o in remaining.items()
                if all(d in level_of or d not in est for d in o.deps)]
        if not wave:
            raise ValueError("cyclic dependencies in program ops")
        dcn = sorted((i for i in wave if est[i].dominant() == "dcn"),
                     key=lambda i: (-est[i].dcn_bytes, -est[i].ici_bytes))
        ici = sorted((i for i in wave if est[i].dominant() == "ici"),
                     key=lambda i: -est[i].ici_bytes)
        chosen = _alternate(dcn, ici)
        levels.append(tuple(chosen))
        for oid in chosen:
            level_of[oid] = len(levels) - 1
            del remaining[oid]
    _telemetry.inc("planner.plan_program_calls")
    _telemetry.inc("planner.est_source.analytic")
    return ProgramPlan(
        estimates=est,
        order=tuple(oid for wave in levels for oid in wave),
        levels=tuple(levels),
        ici_bytes=sum(e.ici_bytes for e in est.values()),
        dcn_bytes=sum(e.dcn_bytes for e in est.values()))
