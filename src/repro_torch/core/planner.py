"""Structural cost model + flow pick for ``algorithm="auto"`` dispatch, and
the joint plan of a whole CommProgram.

The counterpart of ``repro.core.planner`` (``estimate``/``plan``/
``plan_program``) for the ported primitives. It carries no link or FLOP
constants: the reference's constants describe another chip, and this port
prices time only from a profile its tuner (``repro_torch.tuning``) measured
on the card. With no profile ``seconds`` stays unset and the candidates
are ranked by the bytes they move, DCN bytes first, then ICI bytes. Within
one domain that is the reference's ranking by seconds (both byte counts are
divided by the same link rate); across domains it agrees too, because
every candidate here is Pareto-ordered (no flow moves fewer DCN bytes while
moving more ICI bytes than another).

Under an installed (or passed) profile, a candidate whose (flow, stage,
domains) the profile's fitted models cover gets ``seconds`` and
``est_source="measured"``; when any candidate of a race is covered, the
uncovered ones drop out of it (an unpriced flow cannot be compared with a
priced one), and the race is by seconds, as in the reference.

``plan_program`` levels a program's ops by their data dependencies and,
within a level, interleaves DCN-dominant and ICI-dominant ops (largest
first in each domain), as the reference does. With every op of a level
priced, a profile that carries overlap factors races the reference's
candidate orders under its measured ordered-pair factors, across the
dependency-level boundaries too (``_wave_order_state``,
``_boundary_credit``); without factors a level takes the longer of its
two domains' summed seconds (each op's seconds split by the profile's
domain models) or its slowest op, the reference's both-links-stream
budget on measured times. With no time model ``seconds`` and
``serial_seconds`` stay unset and ``est_source`` stays ``"analytic"``.
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


# Stack of installed profiles (``repro_torch.tuning.CommProfile``); the
# innermost one prices every estimate whose (flow, stage, domains) its
# fitted models cover. The planner only needs the duck-typed
# ``seconds_for`` / ``overlap_factor`` / ``has_overlap`` interface, so
# there is no import cycle with the tuning package.
_PROFILES: list = []


def active_profile():
    """The innermost installed profile, or None."""
    return _PROFILES[-1] if _PROFILES else None


@contextlib.contextmanager
def install_profile(profile):
    """Price every ``plan``/``estimate``/``plan_program`` call (and so every
    ``algorithm="auto"`` dispatch) in the scope from ``profile``'s measured
    models. Nests; the innermost profile wins."""
    _PROFILES.append(profile)
    try:
        yield profile
    finally:
        _PROFILES.remove(profile)


def profile_token(profile=None) -> str | None:
    """A cache-key component for ``profile`` (default: the installed one):
    ``"analytic"`` without one, its content ``token()`` with one, None for a
    profile without a token (no alias-safe identity: ``id()`` can be
    recycled after GC, so such a profile disables caching)."""
    prof = profile if profile is not None else active_profile()
    if prof is None:
        return "analytic"
    tok = getattr(prof, "token", None)
    return tok() if callable(tok) else None


def _priced(est: "CommEstimate", profile) -> "CommEstimate":
    """``est`` with the measured seconds of the passed or installed profile
    where its models cover the flow's (algorithm, stage, domains); a
    profile without ``seconds_for`` covers nothing."""
    prof = profile if profile is not None else active_profile()
    seconds_for = getattr(prof, "seconds_for", None)
    if seconds_for is None:
        return est
    t = seconds_for(est.algorithm, est.stage, est.ici_bytes, est.dcn_bytes)
    if t is None:
        return est
    return dataclasses.replace(est, seconds=t, est_source="measured")


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
             block: int = 256, profile=None) -> CommEstimate:
    """Bytes one collective moves per PE. ``payload_bytes`` is the per-PE
    payload (all_gather: the local shard). ``algorithm``: ``naive`` (the
    replicated-intermediate host flow), ``direct`` (one flat collective over
    the group, even across pods), ``compressed`` (the §V-C split with a
    blockwise-int8 DCN hop; ``dtype_bytes``/``block`` size the compression
    ratio), a fused ring flow (``ring_fused`` / ``ag_prologue`` /
    ``rs_epilogue``: the direct flow's bytes, interleaved with compute), or
    ``pidcomm``/``hierarchical`` (the §IX-A split for an all_reduce
    spanning both domains, else direct). ``profile`` (or an
    :func:`install_profile` scope) sets ``seconds`` from its measured
    models where they cover the flow; the byte terms stay structural."""
    return _priced(_estimate(cube, primitive, dims, payload_bytes, algorithm,
                             dtype_bytes=dtype_bytes, block=block), profile)


def _estimate(cube: Hypercube, primitive: str, dims, payload_bytes: float,
              algorithm: str, *, dtype_bytes: int, block: int
              ) -> CommEstimate:
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
         allow_compressed: bool = False, profile=None) -> CommEstimate:
    """Pick the flow with the fewest DCN bytes, then the fewest ICI bytes,
    among the naive host flow, the flat direct collective, (for a group
    spanning both domains) the hierarchical split, the fused ring flows of
    this primitive (groups up to ``comm._LADDER_MAX``) and, with
    ``allow_compressed`` (opt-in: the caller owns the accuracy contract
    that lossy compression bends), the §V-C int8 flow of a pod-crossing
    all_reduce. Ties go away from naive (where bytes cannot separate them
    the native collective runs) and away from the fused flows (their bytes
    tie direct exactly; only a measured time could price them cheaper).

    Under a passed or installed profile the race is by measured seconds
    among the candidates its models cover (the others drop out), with the
    same tie-breaks; when it covers none, the bytes rank as without one."""
    algs = ["naive", "direct", "pidcomm"]
    if allow_compressed and primitive == "all_reduce" \
            and cube.crosses_dcn(dims):
        algs.append("compressed")
    from repro_torch.core import comm
    if cube.group_size(cube.resolve_dims(dims)) <= comm._LADDER_MAX:
        algs += [a for a, p in _FUSED_PRIMITIVE.items() if p == primitive]
    cands = [estimate(cube, primitive, dims, payload_bytes, a,
                      profile=profile) for a in algs]
    measured = [e for e in cands if e.est_source == "measured"]
    if measured:
        return min(measured, key=lambda e: (e.seconds,
                                            e.algorithm == "naive",
                                            e.algorithm in _FUSED_PRIMITIVE))
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
    ``seconds`` (overlap-aware) and ``serial_seconds`` (the sum of the ops')
    stay unset unless a measured profile prices every op. ``est_source``:
    ``"measured"`` when every op is priced from the profile and every
    adjacent pair of every level's order from its measured overlap factors
    (a single-op level has no pair to price); ``"mixed"`` when measurement
    priced part of it (per-op seconds under the both-links budget, or some
    ops uncovered); ``"analytic"`` otherwise."""
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


def _op_estimate(cube: Hypercube, o: ProgramOpSpec, profile) -> CommEstimate:
    """``auto``/``pidcomm`` race the flows; ``naive`` prices the host flow,
    ``hierarchical`` the split, ``compressed`` and the fused flows their
    own models; any other stage (and ring / tree) runs a native flow,
    priced direct -- except an additive all_reduce resolving to ``im``,
    which the dispatcher escalates to the hierarchical split on a group
    spanning both domains."""
    if o.algorithm in ("auto", "pidcomm"):
        return plan(cube, o.primitive, o.dims, o.payload_bytes,
                    allow_compressed=o.allow_compressed, profile=profile)
    alg = REQUEST_TO_PLANNER.get(o.algorithm)
    if alg is not None:
        return estimate(cube, o.primitive, o.dims, o.payload_bytes, alg,
                        profile=profile)
    alg = "direct"
    if (o.primitive == "all_reduce" and o.op == "add"
            and o.algorithm not in ("ring", "tree")):
        from repro_torch.core.comm import resolve_stage
        try:
            if resolve_stage("all_reduce", o.algorithm) == "im":
                alg = "pidcomm"
        except ValueError:
            pass
    return estimate(cube, o.primitive, o.dims, o.payload_bytes, alg,
                    profile=profile)


def _wave_order_state(order, est: Mapping[int, CommEstimate], factor_of
                      ) -> tuple[float, int, int, dict[int, float]]:
    """Price one dispatch order of independent, priced ops under the
    adjacent-pair overlap model: each adjacent pair (a, b) hides ``(1 -
    f(dom_a, dom_b)) * min(sec_a, sec_b)`` of the smaller op's time, f the
    measured serialization factor of the *ordered* domain pair (an
    unmeasured pair: cross-domain links stream concurrently, f = 0;
    same-domain dispatches serialize, f = 1). An op's time is hidden at
    most once. Returns (seconds, measured pairs, pairs, each op's time
    left to hide), the last for the boundary credit."""
    total = sum(est[i].seconds for i in order)
    measured = 0
    left = {i: est[i].seconds for i in order}
    for a, b in zip(order, order[1:]):
        da, db = est[a].dominant(), est[b].dominant()
        f = factor_of(da, db)
        if f is None:
            f = 0.0 if da != db else 1.0
        else:
            measured += 1
        small = a if est[a].seconds <= est[b].seconds else b
        credit = min((1.0 - f) * min(est[a].seconds, est[b].seconds),
                     left[small])
        left[small] -= credit
        total -= credit
    return (max(total, max(est[i].seconds for i in order)),
            measured, len(order) - 1, left)


def _wave_order_seconds(order, est: Mapping[int, CommEstimate],
                        factor_of) -> tuple[float, int, int]:
    """(seconds, measured pairs, pairs) of one order
    (:func:`_wave_order_state` without the time left to hide)."""
    seconds, measured, pairs, _ = _wave_order_state(order, est, factor_of)
    return seconds, measured, pairs


def _boundary_credit(tail: int | None, head: int,
                     est: Mapping[int, CommEstimate], factor_of,
                     left_prev, left_new, deps_of
                     ) -> tuple[float, int, int, int | None]:
    """The boundary pair (the previous level's last op, this level's first)
    overlaps like an intra-level pair when the head does not consume the
    tail's output, and only under a *measured* factor. The credit is
    capped by both ops' time left to hide. Returns (credit, measured pairs,
    pairs, the op whose time left the caller decrements)."""
    if tail is None:
        return 0.0, 0, 0, None
    if tail in deps_of.get(head, ()):
        return 0.0, 0, 0, None          # structurally serialized: no pair
    f = factor_of(est[tail].dominant(), est[head].dominant())
    if f is None:
        return 0.0, 0, 1, None          # unmeasured boundary -> "mixed"
    small = tail if est[tail].seconds <= est[head].seconds else head
    cap = left_prev[tail] if small == tail else left_new[head]
    credit = min((1.0 - f) * min(est[tail].seconds, est[head].seconds), cap)
    return credit, 1, 1, small


def plan_program(cube: Hypercube, ops, *, profile=None) -> ProgramPlan:
    """One planning pass over a whole CommProgram: estimate every op
    (``profile`` or an :func:`install_profile` scope prices them where
    covered), level the ops by data dependency (wave l = ops whose deps
    all sit in waves < l), and order each wave so DCN-dominant and
    ICI-dominant ops alternate, the larger first within each domain (by
    seconds when every op of the wave is priced, else by bytes), so
    neither link sits idle.

    With every op of a wave priced and a profile that carries overlap
    factors, the wave's order races the reference's candidates
    (domain-alternating both ways, domain-grouped both ways, longest
    first) under the measured ordered-pair factors, including the credit
    its head op earns across the previous wave's boundary; the first
    candidate wins ties, and a winner that owes nothing to a measured
    factor keeps the both-links budget below. That budget: the longer of
    the wave's two domains' summed seconds (each op's ICI leg priced by
    the profile's ICI model, the rest of its seconds DCN) or its slowest
    op. Without a time model, nothing is priced."""
    est = {o.op_id: _op_estimate(cube, o, profile) for o in ops}
    prof = profile if profile is not None else active_profile()
    factor_of = getattr(prof, "overlap_factor", None) \
        if prof is not None and getattr(prof, "has_overlap", False) else None
    level_of: dict[int, int] = {}
    remaining = {o.op_id: o for o in ops}
    deps_of = {o.op_id: frozenset(o.deps) for o in ops}
    levels: list[tuple[int, ...]] = []
    seconds: float | None = 0.0 if ops else None
    pairs_measured = pairs_total = 0
    # the boundary state: the previous wave's tail and its time left to
    # hide, carried only while that wave was priced by the measured
    # pairwise model
    prev_tail: int | None = None
    prev_left: dict[int, float] = {}
    while remaining:
        wave = [oid for oid, o in remaining.items()
                if all(d in level_of or d not in est for d in o.deps)]
        if not wave:
            raise ValueError("cyclic dependencies in program ops")
        timed = all(est[i].seconds is not None for i in wave)
        if timed:
            size = {i: (-est[i].seconds,) for i in wave}
        else:
            size = {i: (-est[i].dcn_bytes, -est[i].ici_bytes) for i in wave}
        dcn = sorted((i for i in wave if est[i].dominant() == "dcn"),
                     key=size.__getitem__)
        ici = sorted((i for i in wave if est[i].dominant() == "ici"),
                     key=size.__getitem__)
        inter = _alternate(dcn, ici)
        priced = None
        if factor_of is not None and timed:
            cands, seen = [], set()
            for c in (inter, _alternate(ici, dcn), dcn + ici, ici + dcn,
                      sorted(wave, key=lambda i: -est[i].seconds)):
                t = tuple(c)
                if t not in seen:
                    seen.add(t)
                    cands.append(t)
            priced = []
            for c in cands:
                s_, m_, p_, left = _wave_order_state(c, est, factor_of)
                bc, bm, bp, bsmall = _boundary_credit(
                    prev_tail, c[0], est, factor_of, prev_left, left,
                    deps_of)
                priced.append((s_ - bc, m_ + bm, p_ + bp, left, bc, bsmall))
            if priced[min(range(len(priced)),
                          key=lambda k: priced[k][0])][1] == 0:
                priced = None
        if priced is None:
            chosen = inter
            pairs_total += len(wave) - 1
            prev_tail, prev_left = None, {}
            if timed and seconds is not None and prof is not None:
                ici_t = [prof.seconds_for(est[i].algorithm, est[i].stage,
                                          est[i].ici_bytes, 0.0)
                         for i in wave]
                dcn_t = sum(est[i].seconds - t for i, t in zip(wave, ici_t))
                seconds += max(sum(ici_t), dcn_t,
                               max(est[i].seconds for i in wave))
            else:
                seconds = None
        else:
            best = min(range(len(priced)), key=lambda k: priced[k][0])
            wave_s, n_meas, n_pairs, left, credit, small = priced[best]
            chosen = cands[best]
            pairs_measured += n_meas
            pairs_total += n_pairs
            if small is not None and credit > 0.0:
                # the boundary credit consumes time left to hide like an
                # intra-wave pair: an op is never hidden twice
                (prev_left if small == prev_tail else left)[small] -= credit
            prev_tail, prev_left = chosen[-1], left
            if seconds is not None:
                seconds += wave_s
        levels.append(tuple(chosen))
        for oid in chosen:
            level_of[oid] = len(levels) - 1
            del remaining[oid]

    n_measured = sum(e.est_source == "measured" for e in est.values())
    if n_measured == 0 and pairs_measured == 0:
        src = "analytic"
    elif n_measured == len(est) and pairs_measured == pairs_total:
        src = "measured"
    else:
        src = "mixed"
    serial = None if seconds is None else sum(e.seconds
                                              for e in est.values())
    _telemetry.inc("planner.plan_program_calls")
    _telemetry.inc(f"planner.est_source.{src}")
    if seconds is not None and _telemetry.enabled():
        _telemetry.observe("planner.plan_seconds_us", seconds * 1e6)
        _telemetry.observe("planner.serial_seconds_us", serial * 1e6)
    return ProgramPlan(
        estimates=est,
        order=tuple(oid for wave in levels for oid in wave),
        levels=tuple(levels),
        ici_bytes=sum(e.ici_bytes for e in est.values()),
        dcn_bytes=sum(e.dcn_bytes for e in est.values()),
        seconds=seconds, serial_seconds=serial, est_source=src)
