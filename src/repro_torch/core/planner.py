"""Structural cost model + flow pick for ``algorithm="auto"`` dispatch.

The counterpart of ``repro.core.planner.estimate``/``plan`` for the ported
primitives. It carries no link or FLOP constants: the reference's constants
describe another chip, and this port prices time only from what its own
tuner will measure on the card. Until then ``seconds`` stays unset and the
candidates are ranked by the bytes they move, DCN bytes first, then ICI
bytes. Within one domain that is the reference's ranking by seconds (both
byte counts are divided by the same link rate); across domains it agrees
too, because every candidate here is Pareto-ordered (no flow moves fewer DCN
bytes while moving more ICI bytes than another).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hypercube import Hypercube


@dataclasses.dataclass(frozen=True)
class CommEstimate:
    primitive: str
    algorithm: str                     # naive | hierarchical | direct
    schedule: tuple[str, ...]          # human-readable hop list
    ici_bytes: float                   # per-PE bytes over ICI
    dcn_bytes: float                   # per-PE bytes over DCN
    seconds: float | None = None       # unset until a measured profile
    stage: str = ""                    # the Table II stage this flow maps to


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
    }[primitive]


def _stage(primitive: str, algorithm: str) -> str:
    from repro_torch.core.comm import resolve_stage
    return "naive" if algorithm == "naive" else resolve_stage(primitive,
                                                              "pidcomm")


def estimate(cube: Hypercube, primitive: str, dims, payload_bytes: float,
             algorithm: str = "pidcomm") -> CommEstimate:
    """Bytes one collective moves per PE. ``payload_bytes`` is the per-PE
    payload (all_gather: the local shard). ``algorithm``: ``naive`` (the
    replicated-intermediate host flow), ``direct`` (one flat collective over
    the group, even across pods), or ``pidcomm``/``hierarchical`` (the §IX-A
    split for an all_reduce spanning both domains, else direct)."""
    if algorithm not in ("pidcomm", "naive", "direct", "hierarchical"):
        raise ValueError(f"unknown planner algorithm {algorithm!r}")
    sel = cube.resolve_dims(dims)
    fast, slow = cube.split_fast_slow(sel)
    gf = math.prod(cube.size(d) for d in fast)
    gs = math.prod(cube.size(d) for d in slow)
    g = gf * gs
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
    ici = _group_bytes(primitive, payload_bytes, gf) if gf > 1 else 0.0
    dcn = 0.0
    if gs > 1:
        dcn = _group_bytes(
            primitive,
            payload_bytes * (gf if primitive == "all_gather" else 1), gs)
    return CommEstimate(primitive, "direct", (f"{primitive}[{'x'.join(sel)}]",),
                        ici, dcn, stage=_stage(primitive, "direct"))


def plan(cube: Hypercube, primitive: str, dims,
         payload_bytes: float) -> CommEstimate:
    """Pick the flow with the fewest DCN bytes, then the fewest ICI bytes,
    among the naive host flow, the flat direct collective, and (for a group
    spanning both domains) the hierarchical split. Ties go away from naive:
    where bytes cannot separate them the native collective runs."""
    cands = [estimate(cube, primitive, dims, payload_bytes, a)
             for a in ("naive", "direct", "pidcomm")]
    return min(cands, key=lambda e: (e.dcn_bytes, e.ici_bytes,
                                     e.algorithm == "naive"))
