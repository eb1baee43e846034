#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

  build   builds every hand-written kernel from the sources in this checkout
          (one nvcc per source, all started together) and prints ptxas's
          register / shared-memory report;
  kernel  holds the flash-attention kernel against its plain PyTorch
          version on the card -- f32 within 2e-5, bf16 within 2e-2 of
          max(1, max|plain|) -- in prefill form and in the partial decode
          form, with GQA and without (H == KV), a window, offsets and an
          entirely masked decode chunk; and the reorder kernel (tile_swizzle) against its plain
          version bit for bit: f32 / bf16 / int32, G in {4, 8, 16}, b in
          {1, 8, 16}, D in {64, 128, 2048}, random perms, block_transpose,
          unaligned base pointers and an out-of-range perm entry;
  comm    every ported stage of all_reduce / all_gather / reduce_scatter on
          virtual 8-PE cubes on the card, and every stage of all_to_all on
          the 8-PE cubes and the 16-PE shapes, bit-identical to a plain
          reduction or transpose written here, on integer payloads;
  serve   full-width qwen3-1.7b through the launcher's function
          (batch 4, prompt 32, gen 16) at 1 and 8 PEs: decode logits track
          forward_logits of the same tokens within 5e-2 * max(1, max|ref|)
          (bf16), 1-PE and 8-PE logits agree within the same bound, the
          flash kernel's launches are counted in both, and a profile of
          three decode steps says where a step's time goes. The inputs of
          the kernel's last launch in each form (forward, decode) are kept;
  serve_f32  the same serve at 1 and 8 PEs in f32: logits agree within
          1e-4 * max(1, max|ref|) and the greedy tokens are identical;
  serve_moe  full-width qwen2-moe-a2.7b (bf16, 24 layers, 64 padded experts
          top-4) through the launcher's function at 1 and 8 PEs, one
          topology's weights on the card at a time: ms/step, tok/s, peak
          memory, both kernels' launches (each run must launch the flash
          kernel 24 x 47 times, one per layer and decode step, and the 8-PE
          run the reorder kernel 2 x 24 x 47 times: two all_to_alls per
          layer and decode step), a decode profile, the 1-PE vs 8-PE logits error and
          the share of routing decisions that agree. The inputs of each
          kernel's last launch in each run are kept;
  serve_moe_f32  the same in f32 (TF32 off): 1-PE and 8-PE logits within
          1e-4 * max(1, max|ref|), identical greedy tokens, and identical
          top-k expert ids at every (step, layer, request);
  main_path  each kernel on the inputs the serve phases kept (the shapes and
          positions the serving path gives it): checked against the plain
          version, then timed with the plain version, the bound, and one
          PyTorch call as the library yardstick (SDPA for flash attention,
          index_select for the reorder), which the port never calls.

Then the card's name and power limit, the kernels' JSON line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line; so does a machine without CUDA, or a directory
that holds this script and nothing else of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen3-1.7b"
MOE_ARCH = "qwen2-moe-a2.7b"
BATCH, PROMPT, GEN = 4, 32, 16
PES = (1, 8)
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SERVE_TOL = 5e-2            # bf16 decode vs forward, x max(1, max|ref|)
F32_TOL = 1e-4              # f32 1-PE vs 8-PE logits, x max(1, max|ref|)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by the
# inputs' type (f32 runs outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TPU_KERNEL = "src/repro/kernels/attention/flash.py:115"
KERNEL_SOURCE = "src/repro_torch/kernels/attention/csrc/flash.cu"
REORDER_TPU_KERNEL = "src/repro/kernels/reorder/reorder.py:46"
REORDER_SOURCE = "src/repro_torch/kernels/reorder/csrc/reorder.cu"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``iters`` times between CUDA events (no host launch
    gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# ------------------------------------------------------------------- build
def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    report = {name: [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln] or [log.strip()]
              for name, log in logs.items()}
    return {"seconds": round(time.perf_counter() - t0, 3),
            "libraries": sorted(logs), "ptxas": report}


# ------------------------------------------------------------------ kernel
def _attn_inputs(gen, dtype, B, Sq, Sk, H, KV, hd, dev):
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    return q, k, v


def _compare(got, want, partial) -> float:
    """Largest |kernel - plain| over max(1, max|plain|), per output."""
    pairs = zip(got, want) if partial else [(got, want)]
    worst = 0.0
    for g, w in pairs:
        g, w = g.float(), w.float()
        scale = max(1.0, float(w.abs().max()))
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def _bound(q, k, q_pos, k_pos, causal, window, partial) -> dict:
    """Least time the card could take: each input byte read once, each
    output byte written once, over HBM rate; 4 * hd FLOPs per visible
    (query head, key) pair of this run's positions, over the peak for the
    inputs' type. The larger of the two."""
    from repro_torch.kernels.attention import ref
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    es = q.element_size()
    read = es * (q.numel() + 2 * k.numel()) + 4 * (q_pos.numel()
                                                    + k_pos.numel())
    write = 4 * B * H * Sq * (hd + 2) if partial else es * q.numel()
    visible = int(ref.mask(q_pos, k_pos, causal, window).sum())
    flops = 4 * hd * H * visible
    t_bytes = (read + write) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": read + write, "flops": flops}


def _sdpa(q, k, v, q_pos, k_pos, causal, window):
    """One PyTorch call computing the normalized function (timed only)."""
    from repro_torch.kernels.attention import ref
    mask = ref.mask(q_pos, k_pos, causal, window)[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def phase_kernel(dev) -> dict:
    from repro_torch.kernels.attention import flash, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = []
    worst_ok = True
    # correctness sweep: prefill and partial-decode forms, GQA, windows,
    # offsets, a ragged key tile, an entirely masked decode chunk
    cases = [
        dict(B=2, Sq=64, Sk=64, H=8, KV=2, hd=128, causal=True, window=-1,
             q0=0, k0=0, partial=False),
        dict(B=2, Sq=40, Sk=72, H=8, KV=2, hd=128, causal=True, window=24,
             q0=48, k0=16, partial=False),
        dict(B=1, Sq=33, Sk=33, H=4, KV=4, hd=64, causal=False, window=-1,
             q0=0, k0=0, partial=False),
        dict(B=3, Sq=16, Sk=16, H=4, KV=2, hd=16, causal=True, window=5,
             q0=0, k0=0, partial=False),
        dict(B=8, Sq=1, Sk=6, H=16, KV=8, hd=128, causal=True, window=-1,
             q0=3, k0=0, partial=True, shards=True),  # rows 1-7: masked
        dict(B=4, Sq=1, Sk=48, H=16, KV=8, hd=128, causal=True, window=8,
             q0=20, k0=-4, partial=True),     # rolling slots: negatives
        # no GQA (H == KV), as qwen2-moe decodes: 1 PE, and 8 PEs' shards
        dict(B=4, Sq=1, Sk=48, H=16, KV=16, hd=128, causal=True, window=-1,
             q0=30, k0=0, partial=True),
        dict(B=32, Sq=1, Sk=6, H=2, KV=2, hd=128, causal=True, window=-1,
             q0=40, k0=0, partial=True, shards=True),  # rows 7-31: masked
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for c in cases:
            q, k, v = _attn_inputs(gen, dtype, c["B"], c["Sq"], c["Sk"],
                                   c["H"], c["KV"], c["hd"], dev)
            if c.get("shards"):
                # row r holds cache shard r (slots Sk*r..Sk*r+Sk-1)
                q_pos = torch.full((c["B"], 1), c["q0"], device=dev)
                k_pos = (torch.arange(c["B"], device=dev)[:, None] * c["Sk"]
                         + torch.arange(c["Sk"], device=dev))
            else:
                q_pos = (c["q0"] + torch.arange(c["Sq"], device=dev)
                         ).expand(c["B"], -1)
                k_pos = (c["k0"] + torch.arange(c["Sk"], device=dev)
                         ).expand(c["B"], -1)
            q_pos, k_pos = (p.to(torch.int32).contiguous()
                            for p in (q_pos, k_pos))
            kw = dict(causal=c["causal"], window=c["window"],
                      partial=c["partial"])
            got = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, q_pos, k_pos, **kw)
            err = _compare(got, want, c["partial"])
            ok = err <= KERNEL_TOL[dtype]
            if c["partial"]:
                # rows of an entirely masked chunk: m = -1e30, l = Sk
                dead = (ref.mask(q_pos, k_pos, True, c["window"]).sum(-1)
                        == 0)[:, None, :].expand_as(got[1])
                ok = ok and bool((got[1][dead] == -1e30).all()
                                 and (got[2][dead] == c["Sk"]).all())
            worst_ok &= ok
            checks.append({"dtype": str(dtype).split(".")[-1],
                           "shape": [c[x] for x in ("B", "Sq", "Sk", "H",
                                                    "KV", "hd")],
                           "partial": c["partial"], "window": c["window"],
                           "err": err, "ok": ok})
    reorder = _reorder_checks(dev)
    return {"ok": worst_ok and reorder["ok"], "checks": checks,
            "reorder": reorder}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit pattern (bit-exact comparison, -0.0 included)."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _reorder_checks(dev) -> dict:
    """The reorder kernel against its plain version, bit for bit."""
    from repro_torch.kernels.reorder import ref, reorder
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def payload(rows, D, dtype):
        if dtype == torch.int32:
            return torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, D),
                                 generator=gen, device=dev, dtype=dtype)
        return torch.randn(rows, D, generator=gen, device=dev).to(dtype)

    cases, failed = 0, []
    dtypes = (torch.float32, torch.bfloat16, torch.int32)
    for dtype in dtypes:
        for G in (4, 8, 16):
            for b in (1, 8, 16):
                for D in (64, 128, 2048):
                    x = payload(G * b, D, dtype)
                    perm = torch.randperm(G, generator=gen, device=dev).to(
                        torch.int32)
                    cases += 1
                    if not torch.equal(_bits(reorder.tile_swizzle(x, perm)),
                                       _bits(ref.tile_swizzle(x, perm))):
                        failed.append(["tile_swizzle", str(dtype), G, b, D])
        for g1, g2 in ((2, 2), (2, 4), (4, 2), (4, 4)):
            x = payload(g1 * g2 * 8, 128, dtype)
            cases += 1
            if not torch.equal(_bits(reorder.block_transpose(x, g1, g2)),
                               _bits(ref.block_transpose(x, g1, g2))):
                failed.append(["block_transpose", str(dtype), g1, g2])
        # base pointers off the 16-byte grid, odd widths: the narrow words
        for G, b, D, off in ((8, 1, 3, 1), (5, 3, 7, 1), (16, 8, 64, 2)):
            buf = payload(1, G * b * D + off, dtype).reshape(-1)
            x = buf[off:].view(G * b, D)
            perm = torch.randperm(G, generator=gen, device=dev).to(
                torch.int32)
            cases += 1
            if not torch.equal(_bits(reorder.tile_swizzle(x, perm)),
                               _bits(ref.tile_swizzle(x, perm))):
                failed.append(["unaligned", str(dtype), G, b, D, off])
    # a device perm entry outside [0, G) writes a zero block
    x = payload(16, 64, torch.float32)
    got = reorder.tile_swizzle(
        x, torch.tensor([1, -1, 3, 0], dtype=torch.int32, device=dev))
    cases += 1
    if not (torch.equal(got[4:8], torch.zeros_like(got[4:8]))
            and torch.equal(got[:4], x[4:8])):
        failed.append(["out_of_range"])
    torch.cuda.synchronize()
    return {"ok": not failed, "cases": cases, "failed": failed[:10]}


# -------------------------------------------------------------------- comm
CUBES = [("ring8", {"d": 8}, ("1",)),
         ("2x4", {"r": 2, "c": 4}, ("01",)),
         ("2x2x2", {"a": 2, "b": 2, "c": 2}, ("010", "110", "011"))]


def _plain_group(x, sizes, axes):
    """(G, *instance, *payload) with members cube-major, and its inverse."""
    n = len(sizes)
    inst = [i for i in range(n) if i not in axes]
    perm = list(axes) + inst + list(range(n, x.dim()))
    y = x.permute(perm)
    gshape = [sizes[a] for a in axes]
    g = int(np.prod(gshape))
    y = y.reshape([g] + list(y.shape[len(axes):]))

    def back(z):
        z = z.reshape(gshape + list(z.shape[1:]))
        inv = [perm.index(i) for i in range(len(perm))]
        return z.permute(inv)
    return y, back


def _plain(primitive, x, sizes, axes, op, axis):
    y, back = _plain_group(x, sizes, axes)
    g = y.shape[0]
    red = {"add": lambda t: t.sum(0), "max": lambda t: t.amax(0),
           "min": lambda t: t.amin(0)}[op]
    pa = y.dim() - (x.dim() - len(sizes)) - 1 + axis   # axis without G
    if primitive == "all_reduce":
        return back(red(y).unsqueeze(0).expand_as(y))
    if primitive == "all_gather":
        full = torch.cat([y[r] for r in range(g)], dim=pa)
        return back(full.unsqueeze(0).expand((g,) + tuple(full.shape)))
    chunks = torch.chunk(red(y), g, dim=pa)
    return back(torch.stack(chunks, 0))


CUBES16 = [("4d16", {"w": 2, "x": 2, "y": 2, "z": 2}, 1,
            ("1100", "0110", "1010", "1111")),
           ("ring16", {"d": 16}, 1, ("1",)),
           ("pod2x4x2", {"pod": 2, "dp": 4, "tp": 2}, 2,
            ("110", "011", "100"))]


def _plain_all_to_all(x, sizes, axes, split_axis, concat_axis):
    """Member j's block i along concat_axis = member i's block j along
    split_axis (the NumPy oracle's transpose, in torch)."""
    y, back = _plain_group(x, sizes, axes)
    g = y.shape[0]
    pay0 = y.dim() - (x.dim() - len(sizes))
    blocks = torch.stack(torch.chunk(y, g, dim=pay0 + split_axis), dim=1)
    swapped = blocks.transpose(0, 1)                 # member j <- block j
    out = torch.cat([swapped[:, s] for s in range(g)],
                    dim=pay0 + concat_axis)
    return back(out)


def _comm_all_to_all(dev, gen) -> tuple[int, list]:
    """Every all_to_all stage on the 8-PE cubes and the 16-PE shapes."""
    from repro_torch.core.hypercube import Hypercube
    cubes = [(n, d, 1, bm) for n, d, bm in CUBES] + CUBES16
    cells, failed = 0, []
    for name, dims, pods, bitmaps in cubes:
        cube = Hypercube.build(dims, pods=pods)
        for bm in bitmaps:
            comm = cube.comm(bm)
            g = comm.group_size
            axes = [i for i, b in enumerate(bm) if b == "1"]
            x = torch.randint(-4, 5, cube.dim_sizes + (2 * g, g, 64),
                              generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                xd = x.to(dtype)
                for sa, ca in ((0, 1), (1, 0), (0, 0), (1, 1)):
                    want = _plain_all_to_all(xd, cube.dim_sizes, axes, sa, ca)
                    for stage in ("naive", "pr", "im", "cm", "auto"):
                        got = comm.all_to_all(xd, split_axis=sa,
                                              concat_axis=ca, algorithm=stage)
                        cells += 1
                        if not torch.equal(got, want):
                            failed.append([name, bm, str(dtype), sa, ca,
                                           stage])
    return cells, failed


def phase_comm(dev) -> dict:
    from repro_torch.core.hypercube import Hypercube
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    stages = {"all_reduce": ("naive", "pr", "im", "auto"),
              "reduce_scatter": ("naive", "pr", "im", "auto"),
              "all_gather": ("naive", "pr", "im", "cm", "auto")}
    cells = failures = 0
    for name, dims, bitmaps in CUBES:
        cube = Hypercube.build(dims)
        x = torch.randint(-4, 5, cube.dim_sizes + (64, 128), generator=gen,
                          device=dev).to(torch.float32)
        for bm in bitmaps:
            comm = cube.comm(bm)
            axes = [i for i, b in enumerate(bm) if b == "1"]
            for prim, names in stages.items():
                for op in (("add", "max", "min") if prim != "all_gather"
                           else ("add",)):
                    for axis in (0, 1):
                        if prim == "all_reduce" and axis:
                            continue
                        want = _plain(prim, x, cube.dim_sizes, axes, op, axis)
                        for stage in names:
                            kw = {"algorithm": stage}
                            if prim != "all_gather":
                                kw["op"] = op
                            if prim != "all_reduce":
                                kw["axis"] = axis
                            got = getattr(comm, prim)(x, **kw)
                            cells += 1
                            if not torch.equal(got, want):
                                failures += 1
    a2a_cells, a2a_failed = _comm_all_to_all(dev, gen)
    torch.cuda.synchronize()
    return {"ok": failures == 0 and not a2a_failed, "cells": cells,
            "failures": failures, "pes": 8, "all_to_all_cells": a2a_cells,
            "all_to_all_failed": a2a_failed[:10]}


# ------------------------------------------------------------------- serve
@contextlib.contextmanager
def keep_kernel_inputs(kept: dict, label: str):
    """While open, every launch of the flash wrapper also stores its inputs
    under ``label`` (the last launch wins), so the kernel can be checked and
    timed afterwards on exactly what the serving path gave it."""
    from repro_torch.kernels.attention import flash
    launch = flash.flash_attention

    def keeping(q, k, v, q_pos, k_pos, **kw):
        kept[label] = (q, k, v, q_pos, k_pos, kw)
        return launch(q, k, v, q_pos, k_pos, **kw)

    flash.flash_attention = keeping
    try:
        yield
    finally:
        flash.flash_attention = launch


@contextlib.contextmanager
def keep_reorder_inputs(kept: dict, label: str):
    """While open, every launch of the reorder wrapper also stores its
    inputs under ``label`` (the last launch wins)."""
    from repro_torch.kernels.reorder import reorder
    launch = reorder.tile_swizzle

    def keeping(x, perm):
        kept[label] = (x, perm)
        return launch(x, perm)

    reorder.tile_swizzle = keeping
    try:
        yield
    finally:
        reorder.tile_swizzle = launch


@contextlib.contextmanager
def record_routes(calls: list):
    """While open, every MoE routing appends its top-k expert ids per PE,
    ``(PEs, tokens, k)``, to ``calls`` (device tensors: no sync)."""
    from repro_torch.models import blocks
    route = blocks._route

    def recording(cfg, hn2d, router, cn):
        topi, topv, probs = route(cfg, hn2d, router, cn)
        calls.append(topi.reshape((-1,) + tuple(topi.shape[cn:])))
        return topi, topv, probs

    blocks._route = recording
    try:
        yield
    finally:
        blocks._route = route


def _routes(calls: list, steps: int) -> torch.Tensor:
    """Recorded routings as (steps, layers, B, k) from PE 0; every PE of a
    run routes the same replicated tokens, so the PEs must agree."""
    r = torch.stack(calls)                          # (calls, PEs, B, k)
    if not bool((r == r[:, :1]).all()):
        raise RuntimeError("PEs of one run routed the same tokens apart")
    return r[:, 0].reshape((steps, -1) + tuple(r.shape[2:]))


# device kernels of the port, by the name of their CUDA function
KERNEL_NAMES = {"flash": "flash_fwd", "reorder": "tile_swizzle"}


def profile_decode(run, dev, steps: int = 3) -> dict:
    """Where a decode step's time goes: ``steps`` steps of the same server
    under ``torch.profiler`` (after one warm step), device kernels summed by
    name, the flash kernel's share of device time, and the device's idle
    share of the profiled wall time (profiling adds host overhead, so the
    idle share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.serving import Server, init_cache
    cfg, topo, plan = run["cfg"], run["topo"], run["plan"]
    server = Server(cfg, topo, plan)
    cache = init_cache(cfg, topo, plan, device=dev)
    cube, ba = topo.cube, plan.batch_axes or None
    toks = torch.from_numpy(run["tokens"]).to(dev)

    def step(t):
        pos = torch.full((BATCH,), t, dtype=torch.int64, device=dev)
        server.decode_shard(run["params"], cache,
                            cube.to_cube(toks[:, t], (ba,)),
                            cube.to_cube(pos, (ba,)))

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, 1 + steps):
            step(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            row = by_name.setdefault(ev.name, [0.0, 0])
            row[0] += ev.time_range.elapsed_us()
            row[1] += 1
    busy = sum(r[0] for r in by_name.values())
    if busy <= 0:
        raise RuntimeError("the profiler traced no device events")
    shares = {f"{k}_share_of_device":
              sum(r[0] for name, r in by_name.items() if fn in name) / busy
              for k, fn in KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"steps": steps,
            "wall_ms_per_step": wall_us / 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "idle_share": max(0.0, 1.0 - busy / wall_us),
            **shares,
            "kernels_per_step": sum(r[1] for r in by_name.values()) / steps,
            "top": [[k[:80], v[0] / 1e3 / steps, v[1] // steps]
                    for k, v in top]}


def phase_serve(dev, kept: dict) -> dict:
    """The main path; ``kept`` receives the kernel's inputs per form."""
    from repro_torch.kernels.attention import flash
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import Model
    from repro_torch.models.topology import build_topology

    flash.LAUNCHES = 0          # the main path's run starts here
    runs, launches = {}, 0
    for pes in PES:
        torch.cuda.reset_peak_memory_stats(dev)
        n0 = flash.LAUNCHES
        t0 = time.perf_counter()
        with keep_kernel_inputs(kept, f"decode/{pes}pe"):
            run = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                        pes=pes, device=dev, seed=0, keep_logits=True)
        serve_s = time.perf_counter() - t0
        n_dec = flash.LAUNCHES - n0
        cfg = dataclasses.replace(run["cfg"], tp=pes)
        ftopo = build_topology(cfg, pes)
        if ftopo.cube != run["topo"].cube:
            raise RuntimeError("forward and serve cubes differ")
        # forward over the whole sequence (its length must split over the
        # sequence-parallel PEs); position t's logits follow decode step t
        toks = torch.from_numpy(run["tokens"]).to(dev)
        n1 = flash.LAUNCHES
        with keep_kernel_inputs(kept, f"forward/{pes}pe"):
            fwd = Model(cfg, ftopo).forward_logits(
                run["params"],
                {"tokens": ftopo.cube.to_cube(toks, (ftopo.dp, None))})
        fwd = ftopo.cube.from_cube(fwd, (ftopo.dp, None, ftopo.tp))[:, :-1]
        torch.cuda.synchronize()
        n_fwd = flash.LAUNCHES - n1
        dec = torch.stack(run["logits"], dim=1)           # (B, S-1, Vp)
        scale = max(1.0, float(fwd.abs().max()))
        err = float((dec - fwd).abs().max())
        runs[pes] = {
            "tokens": run["tokens"], "dec": dec, "fwd": fwd,
            "summary": {
                "pes": pes, "cube": run["topo"].cube.describe(),
                "ms_per_step": run["ms_per_step"],
                "p75_ms_per_step": float(np.percentile(run["step_ms"][1:],
                                                       75)),
                "steps_timed": len(run["step_ms"]) - 1,
                "tok_per_s": run["tok_per_s"],
                "serve_s": serve_s,
                "flash_launches_decode": n_dec,
                "flash_launches_forward": n_fwd,
                "decode_vs_forward_err": err,
                "bound": SERVE_TOL * scale,
                "decode_greedy_matches_forward": float(
                    (dec.argmax(-1) == fwd.argmax(-1)).float().mean()),
                "finite": bool(torch.isfinite(dec).all()
                               and torch.isfinite(fwd).all()),
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
            }}
        launches += n_dec + n_fwd      # the profiled steps below are not
        runs[pes]["summary"]["profile"] = profile_decode(run, dev)
        del run
        torch.cuda.empty_cache()

    a, b = runs[PES[0]], runs[PES[-1]]
    # steps whose inputs agree: the prompt, then while greedy tokens agree
    same = np.cumprod(a["tokens"][:, :-1] == b["tokens"][:, :-1], axis=1)
    same = torch.from_numpy(same.astype(bool)).to(dev)
    scale = max(1.0, float(a["fwd"].abs().max()))
    pe_err = max(float((a[x] - b[x]).abs()[same].max()) for x in
                 ("dec", "fwd"))
    gen_agree = float((a["tokens"][:, PROMPT:] == b["tokens"][:, PROMPT:])
                      .mean())
    sums = [runs[p]["summary"] for p in PES]
    ok = (all(s["decode_vs_forward_err"] <= s["bound"] and s["finite"]
              and s["flash_launches_decode"] > 0
              and s["flash_launches_forward"] > 0 for s in sums)
          and pe_err <= SERVE_TOL * scale)
    return {"ok": ok, "arch": ARCH, "batch": BATCH, "prompt_len": PROMPT,
            "gen": GEN, "runs": sums, "pe1_vs_pe8_err": pe_err,
            "pe1_vs_pe8_bound": SERVE_TOL * scale,
            "compared_steps": int(same.sum()),
            "greedy_agreement_pe1_pe8": gen_agree,
            "flash_launches": launches}


def phase_serve_f32(dev) -> dict:
    """1 PE against 8 PEs in f32 (TF32 off): the sharded path and the
    combine must agree with the unsharded one far inside bf16's noise."""
    from repro_torch.launch.serve import serve
    got = {}
    for pes in PES:
        run = serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN, pes=pes,
                    device=dev, seed=0, dtype=torch.float32, keep_logits=True)
        got[pes] = (run["tokens"], torch.stack(run["logits"], dim=1),
                    run["ms_per_step"])
        del run
        torch.cuda.empty_cache()
    (ta, la, ma), (tb, lb, mb) = got[PES[0]], got[PES[-1]]
    scale = max(1.0, float(la.abs().max()))
    err = float((la - lb).abs().max())
    same_tokens = bool((ta == tb).all())
    return {"ok": err <= F32_TOL * scale and same_tokens
            and bool(torch.isfinite(la).all() and torch.isfinite(lb).all()),
            "pe1_vs_pe8_err": err, "bound": F32_TOL * scale,
            "greedy_tokens_identical": same_tokens,
            "greedy_agreement_pe1_pe8": float(
                (ta[:, PROMPT:] == tb[:, PROMPT:]).mean()),
            "ms_per_step": {f"{PES[0]}pe": ma, f"{PES[-1]}pe": mb}}


def _moe_run(dev, pes, dtype, kept=None, kept_reorder=None) -> dict:
    """One full-width MoE serve at ``pes`` PEs, both kernels' counts set to
    0 just before it and read just after; the routings recorded, and with
    ``kept`` the inputs of each kernel's last launch."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.reorder import reorder
    from repro_torch.launch.serve import serve
    calls = []
    torch.cuda.reset_peak_memory_stats(dev)
    keep = contextlib.ExitStack()
    if kept is not None:
        keep.enter_context(keep_kernel_inputs(kept, f"moe/decode/{pes}pe"))
        keep.enter_context(keep_reorder_inputs(kept_reorder, f"decode/{pes}pe"))
    flash.LAUNCHES = reorder.LAUNCHES = 0       # this path's run starts here
    t0 = time.perf_counter()
    with keep, record_routes(calls):
        run = serve(MOE_ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                    pes=pes, device=dev, seed=0, dtype=dtype,
                    keep_logits=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n_flash, n_reorder = flash.LAUNCHES, reorder.LAUNCHES
    steps = len(run["step_ms"])
    run.update(
        dec=torch.stack(run["logits"], dim=1), routes=_routes(calls, steps),
        summary={
            "pes": pes, "cube": run["topo"].cube.describe(),
            "dtype": str(dtype).split(".")[-1],
            "ms_per_step": run["ms_per_step"],
            "p75_ms_per_step": float(np.percentile(run["step_ms"][1:], 75)),
            "steps_timed": steps - 1, "tok_per_s": run["tok_per_s"],
            "serve_s": serve_s,
            "flash_launches": n_flash, "reorder_launches": n_reorder,
            "expected_flash_launches": run["cfg"].n_layers * steps,
            "expected_reorder_launches": (
                2 * run["cfg"].n_layers * steps if pes > 1 else 0),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
            "card_mem_gb": torch.cuda.get_device_properties(dev)
            .total_memory / 2**30,
        })
    run["summary"]["finite"] = bool(torch.isfinite(run["dec"]).all())
    return run


def _moe_ok(s: dict) -> bool:
    return (s["finite"]
            and s["flash_launches"] == s["expected_flash_launches"]
            and s["reorder_launches"] == s["expected_reorder_launches"]
            and s["peak_mem_gb"] < s["card_mem_gb"])


def _drop(run) -> dict:
    """What the comparison needs of a run; the weights leave the card."""
    out = {k: run[k] for k in ("tokens", "dec", "routes", "summary")}
    run.clear()
    torch.cuda.empty_cache()
    return out


def phase_serve_moe(dev, kept: dict, kept_reorder: dict) -> dict:
    """The MoE main path in bf16 at 1 and 8 PEs; ``kept`` and
    ``kept_reorder`` receive the inputs of each kernel's last launch."""
    runs = {}
    for pes in PES:
        run = _moe_run(dev, pes, torch.bfloat16, kept, kept_reorder)
        run["summary"]["profile"] = profile_decode(run, dev)
        runs[pes] = _drop(run)
    a, b = runs[PES[0]], runs[PES[-1]]
    # steps whose inputs agree: the prompt, then while greedy tokens agree
    same = np.cumprod(a["tokens"][:, :-1] == b["tokens"][:, :-1], axis=1)
    same_t = torch.from_numpy(same.astype(bool)).to(dev)     # (B, steps)
    scale = max(1.0, float(a["dec"].abs().max()))
    pe_err = float((a["dec"] - b["dec"]).abs()[same_t].max())
    route_same = (a["routes"] == b["routes"]).all(-1)        # (S, L, B)
    agree = route_same.permute(0, 2, 1)[same_t.T]            # (n, L)
    sums = [runs[p]["summary"] for p in PES]
    return {"ok": all(_moe_ok(s) for s in sums), "arch": MOE_ARCH,
            "batch": BATCH, "prompt_len": PROMPT, "gen": GEN, "runs": sums,
            "pe1_vs_pe8_err": pe_err, "pe1_vs_pe8_scale": scale,
            "compared_steps": int(same_t.sum()),
            "routing_agreement_pe1_pe8": float(agree.float().mean()),
            "routing_agreement_by_layer": [
                round(float(v), 4) for v in agree.float().mean(0)],
            "greedy_agreement_pe1_pe8": float(
                (a["tokens"][:, PROMPT:] == b["tokens"][:, PROMPT:]).mean()),
            "reorder_launches": sum(s["reorder_launches"] for s in sums),
            "flash_launches": sum(s["flash_launches"] for s in sums)}


def phase_serve_moe_f32(dev) -> dict:
    """1 PE against 8 PEs in f32 (TF32 off): logits within 1e-4 x
    max(1, max|ref|), identical greedy tokens, identical top-k expert ids
    at every (step, layer, request)."""
    runs = {pes: _drop(_moe_run(dev, pes, torch.float32)) for pes in PES}
    a, b = runs[PES[0]], runs[PES[-1]]
    scale = max(1.0, float(a["dec"].abs().max()))
    err = float((a["dec"] - b["dec"]).abs().max())
    same_tokens = bool((a["tokens"] == b["tokens"]).all())
    same_routes = bool(torch.equal(a["routes"], b["routes"]))
    sums = [runs[p]["summary"] for p in PES]
    return {"ok": (err <= F32_TOL * scale and same_tokens and same_routes
                   and all(_moe_ok(s) for s in sums)),
            "pe1_vs_pe8_err": err, "bound": F32_TOL * scale,
            "greedy_tokens_identical": same_tokens,
            "routes_identical": same_routes,
            "routing_decisions": int(a["routes"][..., 0].numel()),
            "runs": sums}


def _reorder_main_path(kept: dict) -> dict:
    """The reorder kernel on the inputs of its last launch on the 8-PE MoE
    decode path (the combine all_to_all of layer 24 at step 47)."""
    from repro_torch.kernels.reorder import ref, reorder
    x, perm = kept[f"decode/{PES[-1]}pe"]
    got = reorder.tile_swizzle(x, perm)
    want = ref.tile_swizzle(x, perm)
    torch.cuda.synchronize()
    G = perm.numel()
    nbytes = 2 * x.numel() * x.element_size() + perm.numel() * 4
    return {"name": f"decode/{PES[-1]}pe",
            "dtype": str(x.dtype).split(".")[-1],
            "x": list(x.shape), "blocks": G,
            "block_bytes": x.numel() * x.element_size() // G,
            "exact": bool(torch.equal(_bits(got), _bits(want))),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": time_ms(lambda: reorder.tile_swizzle(x, perm)),
            "plain_ms": time_ms(lambda: ref.tile_swizzle(x, perm)),
            "library_ms": time_ms(
                lambda: torch.index_select(x.view(G, -1), 0, perm)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def phase_main_path(kept: dict, kept_reorder: dict) -> dict:
    """Each kernel on the inputs of its last launch in each form and run of
    the serve and serve_moe phases: held against the plain version, then
    timed."""
    from repro_torch.kernels.attention import flash, ref
    timings = []
    worst_ok = bool(kept)
    for name in sorted(kept):
        q, k, v, q_pos, k_pos, kw = kept[name]
        got = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
        want = ref.flash_attention(q, k, v, q_pos, k_pos, **kw)
        torch.cuda.synchronize()
        partial = kw["partial"]
        gots = got if partial else (got,)
        wants = want if partial else (want,)
        abs_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(gots, wants))
        rel_err = _compare(got, want, partial)
        ms = time_ms(lambda: flash.flash_attention(q, k, v, q_pos, k_pos,
                                                   **kw))
        plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, q_pos, k_pos,
                                                       **kw))
        lib_ms = time_ms(_sdpa(q, k, v, q_pos, k_pos, kw["causal"],
                               kw["window"]))
        b = _bound(q, k, q_pos, k_pos, kw["causal"], kw["window"], partial)
        ok = rel_err <= KERNEL_TOL[q.dtype]
        worst_ok &= ok
        timings.append({"name": name, "dtype": str(q.dtype).split(".")[-1],
                        "q": list(q.shape), "kv": list(k.shape), **kw,
                        "max_abs_err": abs_err, "err": rel_err, "ok": ok,
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        **b})
    reorder = _reorder_main_path(kept_reorder)
    return {"ok": worst_ok and reorder["exact"], "main_path": timings,
            "reorder": reorder}


# -------------------------------------------------------------------- main
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repository's src/repro_torch is missing "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    results, failed, kept, kept_reorder = {}, [], {}, {}
    for name, fn in (("build", lambda: phase_build()),
                     ("kernel", lambda: phase_kernel(dev)),
                     ("comm", lambda: phase_comm(dev)),
                     ("serve", lambda: phase_serve(dev, kept)),
                     ("serve_f32", lambda: phase_serve_f32(dev)),
                     ("serve_moe", lambda: phase_serve_moe(dev, kept,
                                                           kept_reorder)),
                     ("serve_moe_f32", lambda: phase_serve_moe_f32(dev)),
                     ("main_path", lambda: phase_main_path(kept,
                                                           kept_reorder))):
        needs = (("serve", "serve_moe") if name == "main_path"
                 else ("build",))
        missing = [n for n in needs if n in failed]
        if name != "build" and missing:
            failed.append(name)
            emit(name, ok=False, error=f"skipped: {missing} failed")
            continue
        t0 = time.perf_counter()
        try:
            res = fn()
            res.setdefault("ok", True)
        except Exception as e:  # noqa: BLE001 -- report every phase
            res = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc(limit=8)}
        res["phase_s"] = round(time.perf_counter() - t0, 3)
        results[name] = res
        emit(name, **res)
        if not res["ok"]:
            failed.append(name)

    print(card_line(), flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    kern, serve_res = results["main_path"], results["serve"]
    moe_res = results["serve_moe"]
    head = next(t for t in kern["main_path"] if t["name"] == "decode/8pe")
    swz = kern["reorder"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": serve_res["flash_launches"] + moe_res["flash_launches"],
        "launches_by_path": {ARCH: serve_res["flash_launches"],
                             MOE_ARCH: moe_res["flash_launches"]},
        "max_abs_err": max(t["max_abs_err"] for t in kern["main_path"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "at": head["name"],
        "shapes": {t["name"]: {k: t[k] for k in (
            "q", "kv", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")} for t in kern["main_path"]},
    }, {
        "name": "tile_swizzle", "route": "cuda", "source": REORDER_SOURCE,
        "replaces": REORDER_TPU_KERNEL,
        "launches": moe_res["reorder_launches"],
        "max_abs_err": swz["max_abs_err"], "ms": swz["ms"],
        "plain_ms": swz["plain_ms"], "bound_ms": swz["bound_ms"],
        "bound_by": swz["bound_by"], "library_ms": swz["library_ms"],
        "at": swz["name"], "x": swz["x"], "blocks": swz["blocks"],
    }], "total_s": round(time.perf_counter() - t_all, 3)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
