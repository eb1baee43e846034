"""Collective microbenchmarks through the real dispatch (the tuning sweep).

The counterpart of ``repro.tuning.microbench``. Each cell is one
(primitive, candidate algorithm, dim selection, payload size), run through
the port's ``Communicator`` on cube tensors of the given device and timed
by :func:`bench`: on CUDA, CUDA events around each of ``reps`` calls after
``warmup`` calls, the median; on the CPU, the wall-clock median. Tests
replace ``bench`` to feed synthetic times.

Every cell runs under a :class:`~repro_torch.core.comm.CommTrace`, so the
recorded event supplies the structural facts of the executed flow (stage,
per-PE ICI / DCN bytes) and the measurement supplies the time; the pair
becomes one :class:`~repro_torch.tuning.profile.MeasuredSample`.

The candidate set per cell is the reference's: ``naive`` and ``pidcomm``
(the native flow, priced as ``direct``) everywhere; ``naive`` and
``hierarchical`` for an all_reduce whose group spans both domains (where
the dispatcher escalates ``direct`` away); ``naive`` alone for the
broadcast (one registered flow); plus the fused ring flows (``ring_fused``
/ ``ag_prologue`` for all_gather, ``rs_epilogue`` for reduce_scatter), run
without a consumer, so a profile prices fused against unfused. The
reference's sweep measures no ``compressed`` cell, and neither does this.

Program-level cells (the overlap sweep) time two independent all_reduces
dispatched back to back against each alone, giving an
:class:`~repro_torch.tuning.profile.OverlapSample`; :func:`measure_program`
times a whole lowered ``CommProgram``.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.tuning.profile import MeasuredSample, OverlapSample

# Sweep defaults (per-PE bytes), the reference's; larger sizes are the
# caller's choice.
DEFAULT_SIZES = (64 * 1024, 256 * 1024, 1024 * 1024)

PE_PRIMITIVES = ("all_to_all", "reduce_scatter", "all_reduce", "all_gather")
ROOTED_PRIMITIVES = ("scatter", "gather", "reduce", "broadcast")

# executed registry flow -> the planner candidate it prices as (everything
# unlisted ran the native direct flow)
_FLOW_TO_CANDIDATE = {
    "naive": "naive",
    "hierarchical": "hierarchical",
    "compressed": "compressed",
    "ring_fused": "ring_fused",
    "ag_prologue": "ag_prologue",
    "rs_epilogue": "rs_epilogue",
}


def bench(fn, *, warmup: int = 2, reps: int = 5, device="cuda") -> float:
    """Median seconds of one ``fn()`` call after ``warmup`` calls: CUDA
    events around each call on a CUDA device (the device's own time,
    synchronized on the end event), the wall clock elsewhere."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def candidates(cube, primitive: str, dims) -> list[str]:
    """Dispatch algorithm requests to measure for one cell."""
    sel = cube.resolve_dims(dims)
    fast, slow = cube.split_fast_slow(sel)
    if primitive == "all_reduce" and fast and slow:
        # the dispatcher escalates a direct request to the hierarchical
        # split here, so "direct" is unreachable: measure what runs
        return ["naive", "hierarchical"]
    if primitive == "broadcast":
        return ["naive"]
    out = ["naive", "pidcomm"]
    if primitive == "all_gather":
        out += ["ring_fused", "ag_prologue"]
    elif primitive == "reduce_scatter":
        out += ["rs_epilogue"]
    return out


def _pe_cell(cube, comm, primitive: str, n: int, algorithm: str, device):
    """The timed callable of one PE<->PE cell: an f32 cube tensor
    ``(*dim_sizes, n)``, so each PE's payload is ``4 * n`` bytes."""
    x = torch.ones(cube.dim_sizes + (n,), dtype=torch.float32, device=device)
    if primitive == "all_reduce":
        return lambda: comm.all_reduce(x, algorithm=algorithm)
    if primitive == "reduce_scatter":
        return lambda: comm.reduce_scatter(x, axis=0, algorithm=algorithm)
    if primitive == "all_gather":
        return lambda: comm.all_gather(x, axis=0, algorithm=algorithm)
    if primitive == "all_to_all":
        return lambda: comm.all_to_all(x, split_axis=0, concat_axis=0,
                                       algorithm=algorithm)
    raise ValueError(primitive)


def _rooted_cell(comm, primitive: str, n: int, algorithm: str, device):
    """The timed callable of one host-rooted cell: a host value of ``(g,
    n)`` f32, so each member's chunk is ``4 * n`` bytes."""
    host = np.ones((comm.group_size, n), np.float32)
    if primitive == "scatter":
        return lambda: comm.scatter(host, axis=0, device=device,
                                    algorithm=algorithm)
    if primitive == "broadcast":
        return lambda: comm.broadcast(host, device=device,
                                      algorithm=algorithm)
    on_dev = comm.scatter(host, axis=0, device=device)
    if primitive == "gather":
        return lambda: comm.gather(on_dev, axis=0, algorithm=algorithm)
    if primitive == "reduce":
        return lambda: comm.reduce(on_dev, axis=0, algorithm=algorithm)
    raise ValueError(primitive)


def measure_cell(cube, primitive: str, dims, nbytes: int,
                 algorithms: Sequence[str] | None = None, *,
                 reps: int = 5, warmup: int = 2,
                 device="cuda") -> list[MeasuredSample]:
    """Measure one (primitive, dim selection, size) cell across candidate
    dispatch algorithms; one sample per executed flow."""
    from repro_torch.core.comm import CommTrace
    sel = cube.resolve_dims(dims)
    comm = cube.comm(sel)
    g = comm.group_size
    # per-PE f32 elements, divisible by the group for the rs / aa splits
    n = max(int(nbytes) // 4, g)
    n -= n % g
    if algorithms is None:
        algorithms = candidates(cube, primitive, sel)
    samples: list[MeasuredSample] = []
    for alg in algorithms:
        if primitive in PE_PRIMITIVES:
            call = _pe_cell(cube, comm, primitive, n, alg, device)
        else:
            call = _rooted_cell(comm, primitive, n, alg, device)
        with CommTrace() as tr:
            seconds = bench(call, warmup=warmup, reps=reps, device=device)
        ev = next((e for e in tr.events if e.primitive == primitive), None)
        if ev is None:       # group of 1: nothing dispatched
            continue
        samples.append(MeasuredSample(
            primitive=primitive,
            algorithm=_FLOW_TO_CANDIDATE.get(ev.flow, "direct"),
            stage=ev.stage, bitmap=ev.bitmap, nbytes=4 * n,
            ici_bytes=ev.ici_bytes, dcn_bytes=ev.dcn_bytes,
            seconds=seconds))
    return samples


# ------------------------------------------------- program-level overlap
# one mid-range payload is enough for a ratio of same-size runs; two sizes
# give the median fit a noise anchor
DEFAULT_OVERLAP_SIZES = (256 * 1024, 1024 * 1024)


def _domain_comms(cube) -> dict:
    """One communicator per link domain of the cube: ``"ici"`` over the
    fast dims, ``"dcn"`` over the pod-crossing dims (when present). An
    all_reduce over each is the domain's representative flow."""
    fast = tuple(d for d in cube.dim_names if d not in cube.dcn_dims)
    out = {}
    if fast:
        out["ici"] = cube.comm(fast)
    if cube.dcn_dims:
        out["dcn"] = cube.comm(tuple(cube.dcn_dims))
    return out


def _payload(cube, nbytes: int, device, fill: float = 1.0):
    n = max(int(nbytes) // 4, 1)
    return torch.full(cube.dim_sizes + (n,), fill, dtype=torch.float32,
                      device=device)


def _solo_seconds(cube, comm, nbytes: int, *, reps: int, warmup: int,
                  device) -> float:
    x = _payload(cube, nbytes, device)
    return bench(lambda: comm.all_reduce(x), warmup=warmup, reps=reps,
                 device=device)


def _pair_seconds(cube, comm_a, comm_b, nbytes: int, *, reps: int,
                  warmup: int, device) -> float:
    """Seconds of A then B dispatched back to back (one timed call)."""
    x = _payload(cube, nbytes, device)
    y = _payload(cube, nbytes, device, 2.0)

    def pair():
        return comm_a.all_reduce(x), comm_b.all_reduce(y)

    return bench(pair, warmup=warmup, reps=reps, device=device)


def measure_overlap_pair(cube, dom_a: str, dom_b: str, nbytes: int, *,
                         reps: int = 5, warmup: int = 2, device="cuda",
                         solo: dict | None = None) -> OverlapSample | None:
    """Measure one ordered domain pair; None when the cube lacks a domain.
    ``solo`` optionally supplies pre-measured {domain: seconds} at this
    size."""
    comms = _domain_comms(cube)
    if dom_a not in comms or dom_b not in comms:
        return None
    comm_a, comm_b = comms[dom_a], comms[dom_b]
    solo = solo or {}
    kw = dict(reps=reps, warmup=warmup, device=device)
    sec_a = solo.get(dom_a)
    if sec_a is None:
        sec_a = _solo_seconds(cube, comm_a, nbytes, **kw)
    sec_b = solo.get(dom_b)
    if sec_b is None:
        sec_b = _solo_seconds(cube, comm_b, nbytes, **kw)
    return OverlapSample(
        dom_a=dom_a, dom_b=dom_b,
        primitive_a="all_reduce", primitive_b="all_reduce",
        bitmap_a=comm_a.bitmap, bitmap_b=comm_b.bitmap,
        nbytes=4 * max(int(nbytes) // 4, 1), seconds_a=sec_a,
        seconds_b=sec_b,
        seconds_pair=_pair_seconds(cube, comm_a, comm_b, nbytes, **kw))


def overlap_sweep(cube, *, sizes: Sequence[int] = DEFAULT_OVERLAP_SIZES,
                  reps: int = 5, warmup: int = 2, device="cuda",
                  progress=None) -> list[OverlapSample]:
    """Every ordered domain pair the cube can express, at each size; the
    solo ops are timed once per (domain, size)."""
    comms = _domain_comms(cube)
    samples: list[OverlapSample] = []
    for nbytes in sizes:
        solo = {d: _solo_seconds(cube, c, nbytes, reps=reps, warmup=warmup,
                                 device=device) for d, c in comms.items()}
        for dom_a in comms:
            for dom_b in comms:
                s = measure_overlap_pair(cube, dom_a, dom_b, nbytes,
                                         reps=reps, warmup=warmup,
                                         device=device, solo=solo)
                samples.append(s)
                if progress is not None:
                    progress(dom_a, dom_b, nbytes, s)
    return samples


def measure_program(lowered, inputs: Sequence, *, reps: int = 5,
                    warmup: int = 2, device="cuda") -> float:
    """Seconds of one execution of a lowered ``CommProgram`` on
    ``inputs`` -- what the joint plan's ``seconds`` is held against."""
    return bench(lambda: lowered.execute(*inputs), warmup=warmup, reps=reps,
                 device=device)


def selections(cube) -> list[tuple[str, ...]]:
    """The reference's sweep selections: the innermost dim and, on a cube
    of more than one dim, the whole cube (a small-group and a large-group
    anchor; on a pod-spanning cube the second exercises the DCN models)."""
    out = [(cube.dim_names[-1],)]
    if len(cube.dim_names) > 1:
        out.append(tuple(cube.dim_names))
    return out


def sweep(cube, *, sizes: Sequence[int] = DEFAULT_SIZES,
          primitives: Sequence[str] | None = None,
          dims: Sequence | None = None, reps: int = 5, warmup: int = 2,
          device="cuda", progress=None) -> list[MeasuredSample]:
    """The tuning sweep: every primitive x candidate x size over each
    selection of ``dims`` (default :func:`selections`). ``progress(
    primitive, selection, nbytes, samples)`` is called after each cell."""
    prims = tuple(primitives) if primitives is not None \
        else PE_PRIMITIVES + ROOTED_PRIMITIVES
    sels = [cube.resolve_dims(d) for d in dims] if dims is not None \
        else selections(cube)
    samples: list[MeasuredSample] = []
    for primitive in prims:
        for sel in sels:
            for nbytes in sizes:
                cell = measure_cell(cube, primitive, sel, nbytes,
                                    reps=reps, warmup=warmup, device=device)
                samples.extend(cell)
                if progress is not None:
                    progress(primitive, sel, nbytes, cell)
    return samples


__all__ = ["DEFAULT_OVERLAP_SIZES", "DEFAULT_SIZES", "PE_PRIMITIVES",
           "ROOTED_PRIMITIVES", "bench", "candidates", "measure_cell",
           "measure_overlap_pair", "measure_program", "overlap_sweep",
           "selections", "sweep"]
