"""Dry run: trace every (architecture x input shape) cell on the production
cube and record memory, operations and the collective schedule.

The counterpart of ``repro.launch.dryrun``. The reference lowers and
compiles each cell for 512 fake CPU devices and never runs it. The port
traces each cell on PyTorch's ``meta`` device: every tensor has its shape
and dtype and no storage, so the 256- or 512-PE cube at full width runs
its train step, prefill or decode step without allocating a byte. This is
the one entry point of the port that does not run on the card, because
nothing it records depends on values: bytes held, operations and
collectives are functions of the shapes. The kernels dispatch by device
(``kernels/*/ops.py``), so on meta every kernel takes its plain version,
which has the kernel's shapes; the plain attention materializes its score
chunks, which the kernel never allocates, so ``temp_size_in_bytes`` is an
upper bound on what the card holds.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k [--multipod | --all] [--probe] [--profile P.json]

A cell's record keeps the reference's keys: ``params_total`` /
``params_active``, ``cube``, ``comm_trace`` (``CommTrace.summary()``) and
``est_sources``, ``program_cache`` (the ``LOWER_STATS`` delta),
``telemetry`` (the cell's scoped metrics), ``lower_s`` (here the trace's
seconds; ``compile_s`` is null, since nothing compiles), ``memory`` per PE
(``argument_size_in_bytes``: what the cell's function takes -- params,
optimizer state and batch, or cache, tokens and positions;
``output_size_in_bytes``; ``temp_size_in_bytes``: the peak of live bytes
less the arguments, divided by the PEs), ``cost`` per PE (``flops``: the
formulas ``FlopCounterMode`` counts by, ``torch.utils.flop_counter.
flop_registry``, on each aten op that has one, without the mode's
decompositions -- the same count on every smoke cell of the ten archs, 6x
faster; ``bytes accessed``: each aten op's inputs and outputs,
views excluded -- eager bytes, with no fusion), ``collectives`` (the data
movements that ran, ``core.comm.BodyTrace``: by kind and group size, with
the per-PE bytes of each result) and ``planner_drift`` (``comm_drift``).
``comm_seconds`` is the planner's time for the recorded schedule under an
installed measured profile (``--profile``), else null.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.core import program as program_mod
from repro_torch.core.comm import BodyTrace, CommTrace
from repro_torch.launch.mesh import mesh_name, production_cube
from repro_torch.models import layers as layers_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (
    _resident_defs, leaves, param_defs, param_specs, set_path, trainable)
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology
from repro_torch.runtime.trainer import (
    TrainConfig, init_opt_state, input_batch_specs, make_train_step)
from repro_torch.telemetry import drift as drift_mod
from repro_torch.telemetry import metrics as telemetry_metrics

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# The collective kinds (``core.comm.BODY_KINDS``) each (primitive, executed
# flow) runs: the port's table of its registered bodies, in the place of
# the reference's HLO ops per flow. The naive and pr bodies move their
# replicated buffers inside one all_reduce / reduce_scatter / all_to_all
# body; ring and tree are one all_reduce body each; the hierarchical split
# runs a reduce-scatter, a DCN all-reduce of the shard and an all-gather,
# of which the reference's table asks for the two ICI hops, as this one
# does; the compressed flow's DCN hop moves int8 codes inline. Rooted
# primitives move data to or from the host and run no collective.
_EXECUTED_BODIES = {
    ("all_reduce", "hierarchical"): {"reduce-scatter", "all-gather"},
    ("all_reduce", "compressed"): {"reduce-scatter", "all-gather"},
    **{("all_reduce", f): {"all-reduce"}
       for f in ("naive", "pr", "im", "ring", "tree")},
    **{("reduce_scatter", f): {"reduce-scatter"}
       for f in ("naive", "pr", "im", "rs_epilogue")},
    **{("all_gather", f): {"all-gather"}
       for f in ("naive", "pr", "im", "cm", "ring_fused", "ag_prologue")},
    **{("all_to_all", f): {"all-to-all"} for f in ("naive", "pr", "im",
                                                   "cm")},
}


def comm_drift(trace_summary: dict, collectives: dict) -> dict:
    """Cross-check the planner's recorded schedule (``CommTrace.summary()``)
    against the data movements that ran (``collectives``, a
    ``BodyTrace.summary()``) in the same cell, as the reference checks it
    against its compiled module's collectives (its report's keys).

    Every (primitive, flow) the communicator dispatched must have run its
    bodies (``_EXECUTED_BODIES``); an expected kind that never ran means
    the runtime executed something other than what the planner recorded.
    Bytes: result bytes below the drift band's low edge
    (``telemetry.drift.DEFAULT_BAND``) of the planned ICI + DCN bytes flag
    over-estimation; above it is informational (the backward's collectives
    run bodies the forward's trace does not plan)."""
    expected: set[str] = set()
    flows = []
    for key in trace_summary.get("by_flow", {}):
        primitive, flow = key.split("/", 1)
        want = _EXECUTED_BODIES.get((primitive, flow))
        if want is None:       # rooted primitives: host transfers
            continue
        flows.append(key)
        expected |= want
    present = {op for op, d in collectives.items() if d.get("count")}
    missing = sorted(expected - present)
    trace_bytes = (trace_summary.get("ici_bytes", 0.0)
                   + trace_summary.get("dcn_bytes", 0.0))
    ran_bytes = sum(d.get("result_bytes", 0) for d in collectives.values())
    ratio = (ran_bytes / trace_bytes) if trace_bytes > 0 else None
    drift = bool(missing) or (bool(flows) and trace_bytes > 0
                              and (ran_bytes == 0
                                   or (ratio is not None
                                       and drift_mod.underrun(ratio))))
    return {"drift": drift, "missing_ops": missing,
            "checked_flows": sorted(flows),
            "expected_ops": sorted(expected), "hlo_ops": sorted(present),
            "hlo_over_trace_bytes": ratio}


# --------------------------------------------------------------- inputs
def _meta_params(cfg: ModelConfig, topo, *, resident: bool = False,
                 dtype: torch.dtype | None = None) -> dict:
    """Every weight on the cube as ``init_params`` lays it out, on meta
    (``dtype``: stored in that type instead of the masters' f32)."""
    defs = param_defs(cfg, topo)
    if resident:
        defs = _resident_defs(defs)
    out: dict = {}
    for path, d in leaves(defs):
        dt = dtype if dtype is not None and d.dtype == torch.float32 \
            else d.dtype
        set_path(out, path, topo.cube.to_cube(
            torch.empty(d.shape, dtype=dt, device=META), d.spec))
    return out


def input_structs(cfg: ModelConfig, topo, shape: dict,
                  device=META) -> dict:
    """The batch of a train or prefill cell on the cube, on ``device``
    (meta: no allocation), in the types the port holds it: token ids
    int64 (``runtime.trainer.place_batch``), frontend inputs bf16."""
    S, B = shape["seq"], shape["batch"]
    specs = input_batch_specs(cfg, topo)

    def struct(shp, dt, key):
        return topo.cube.to_cube(torch.empty(shp, dtype=dt, device=device),
                                 specs[key])

    if shape["kind"] not in ("train", "prefill"):
        raise ValueError(shape)
    S_tok = S // 4 if cfg.is_encoder_decoder else S   # decoder: S/4 text
    batch = {"tokens": struct((B, S_tok), torch.int64, "tokens"),
             "labels": struct((B, S_tok), torch.int64, "labels")}
    if cfg.frontend == "patch":
        batch["patches"] = struct((B, cfg.frontend_tokens, cfg.frontend_dim),
                                  torch.bfloat16, "patches")
    if cfg.is_encoder_decoder:
        batch["frames"] = struct((B, S, cfg.frontend_dim), torch.bfloat16,
                                 "frames")
    if shape["kind"] == "prefill":
        batch.pop("labels")
    return batch


# ---------------------------------------------------------------- meter
# ops that move no data: allocating factories whose output nothing reads
# or writes yet, and the reshape view autograd treats as a new tensor
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_unsafe_view"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _Meter(TorchDispatchMode):
    """The operations of every aten op with a flop formula, the bytes
    every aten op reads and writes (views and bare allocations excluded),
    and the live bytes of the storages the ops make, with their peak. A
    storage's bytes count from the op that makes it until it is freed
    (autograd's saved tensors keep theirs alive)."""

    def __init__(self, held):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self._keys: set = set()
        self.live = self.peak = 0
        for t in _tensors(held):
            self._track(t)
        self.held = self.live
        self.peak = self.live

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._keys:
            return
        n = st.nbytes()
        self._keys.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._keys.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops = flop_registry.get(func.overloadpacket)
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out


def _per_pe_bytes(tree, cn: int) -> int:
    """One PE's bytes of a tree of cube tensors (a tensor of fewer than
    ``cn`` axes -- the step counter -- whole)."""
    return sum(math.prod(t.shape[cn:]) * t.element_size()
               if t.dim() >= cn else t.numel() * t.element_size()
               for t in _tensors(tree))


# --------------------------------------------------------------- a cell
def _setup(cfg: ModelConfig, shape: dict, pes: int, pods: int, *,
           resident: bool, cache_dtype: str, serve_bf16: bool):
    """(topology, the function, its arguments, record extras)."""
    kind = shape["kind"]
    if kind == "train":
        topo = build_topology(cfg, pes, pods=pods,
                              global_batch=shape["batch"])
        tc = TrainConfig()
        masters = trainable(_meta_params(cfg, topo), param_specs(cfg, topo),
                            topo.cube)
        args = (masters, init_opt_state(masters, cfg, topo, tc),
                input_structs(cfg, topo, shape))
        return topo, make_train_step(cfg, topo, tc), args, {}
    if kind == "prefill":
        # the reference's prefill runs on a training-style topology
        topo = build_topology(cfg, pes, pods=pods,
                              global_batch=shape["batch"])
        plan = make_serve_plan(cfg, topo, S_ctx=shape["seq"],
                               global_batch=shape["batch"])
        server = Server(cfg, topo, plan)
        args = (_meta_params(cfg, topo), input_structs(cfg, topo, shape))
        return topo, server.prefill_shard, args, {}
    topo = build_serve_topology(cfg, pes, pods=pods)
    plan = make_serve_plan(cfg, topo, S_ctx=shape["seq"],
                           global_batch=shape["batch"],
                           cache_dtype=cache_dtype)
    server = Server(cfg, topo, plan, resident=resident)
    params = _meta_params(cfg, topo, resident=resident,
                          dtype=torch.bfloat16 if serve_bf16 else None)
    ba = (plan.batch_axes or None,)
    tok, pos = (topo.cube.to_cube(torch.empty((plan.global_batch,),
                                              dtype=torch.int64,
                                              device=META), ba)
                for _ in range(2))
    cache = init_cache(cfg, topo, plan, device=META)
    extras = {"serve_plan": dict(S_cache=plan.S_cache,
                                 batch_axes=plan.batch_axes,
                                 kv_axes=plan.kv_axes)}
    return topo, server.decode_shard, (params, cache, tok, pos), extras


def _cell(cfg: ModelConfig, shape: dict, pes: int, pods: int = 1, *,
          resident: bool = False, cache_dtype: str = "bf16",
          serve_bf16: bool = False) -> dict:
    """Trace one cell -- ``cfg`` at ``shape`` (``SHAPES``' layout) on a cube
    of ``pes`` PEs in ``pods`` pods -- on meta and return its measured
    record (the keys of ``run_cell`` after its header)."""
    t0 = time.monotonic()
    topo, fn, args, rec = _setup(cfg, shape, pes, pods, resident=resident,
                                 cache_dtype=cache_dtype,
                                 serve_bf16=serve_bf16)
    cn, n_pe = topo.cube.ndim, topo.cube.ndev
    lower0 = dict(program_mod.LOWER_STATS)
    trace, bodies = CommTrace(), BodyTrace()
    with trace, bodies, telemetry_metrics.scoped_metrics() as treg:
        meter = _Meter(args)
        with meter:
            out = fn(*args)
        out_bytes = _per_pe_bytes(out, cn)
        del out
    rec["cube"] = topo.cube.describe()
    rec["comm_trace"] = trace.summary()
    rec["est_sources"] = rec["comm_trace"].get("est_sources", {})
    seconds = [e.seconds for e in trace.events]
    rec["comm_seconds"] = (sum(seconds) if seconds and None not in seconds
                           else None)
    rec["program_cache"] = {k: program_mod.LOWER_STATS[k] - lower0[k]
                            for k in program_mod.LOWER_STATS}
    rec["telemetry"] = treg.snapshot()
    rec["lower_s"] = round(time.monotonic() - t0, 1)
    rec["compile_s"] = None
    rec["memory"] = {
        "argument_size_in_bytes": _per_pe_bytes(args, cn),
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": max(meter.peak - meter.held, 0) // n_pe}
    rec["cost"] = {"flops": meter.flops / n_pe,
                   "bytes accessed": meter.bytes_accessed / n_pe}
    rec["collectives"] = bodies.summary()
    rec["planner_drift"] = comm_drift(rec["comm_trace"], rec["collectives"])
    return rec


def _header(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = configs.get(arch)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count()}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    """One cell on the production cube (``launch.mesh.production_cube``)."""
    cfg = configs.get(arch)
    rec = _header(arch, shape_name, multi_pod)
    if shape_name == "long_500k" and not cfg.subquadratic:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full attention: 500k-token decode requires "
                         "sub-quadratic attention memory (see DESIGN.md)")
        return rec
    pes, pods = production_cube(multi_pod)
    rec.update(_cell(cfg, SHAPES[shape_name], pes, pods))
    rec["status"] = "ok"
    return rec


# ------------------------------------------------------------- the probe
def run_probe(arch: str, shape_name: str, *, multi_pod: bool,
              cfg_transform=None, **lower_kw) -> dict:
    """The reference's two-point cost probe: the cell at 1 and 2 units of
    layers, extrapolated linearly to the config's units,

        cost(L units) = c1 + (L - 1) * (c2 - c1).

    The port traces every layer (nothing is scanned), so its costs are
    linear in the units and the extrapolation is its full count; the probe
    keeps the reference's record keys (``cost_x``, ``collectives_x``,
    ``probe_raw``, ``n_units``) for the perf harness."""
    cfg0 = configs.get(arch)
    if cfg_transform is not None:
        cfg0 = cfg_transform(cfg0)
    return _probe(cfg0, lambda cfg: _lower_cell_cfg(
        cfg, shape_name, multi_pod=multi_pod, **lower_kw))


def _probe(cfg0: ModelConfig, trace) -> dict:
    """The two-point probe of ``cfg0``: ``trace(cfg)`` (a cell's record)
    at 1 and 2 units of layers, extrapolated to ``cfg0``'s units."""
    unit = cfg0.unit()
    n_units = cfg0.n_layers // unit
    c1, c2 = (trace(dataclasses.replace(
        cfg0, n_layers=unit * k,
        n_enc_layers=(min(k, cfg0.n_enc_layers)
                      if cfg0.is_encoder_decoder else 0)))
        for k in (1, 2))

    def xp(a, b):
        return a + (n_units - 1) * (b - a)

    cost = {k: xp(c1["cost"].get(k, 0.0), c2["cost"].get(k, 0.0))
            for k in set(c1["cost"]) | set(c2["cost"])}
    coll = {}
    for op in set(c1["collectives"]) | set(c2["collectives"]):
        d1 = c1["collectives"].get(op, {"by_group": {}})
        d2 = c2["collectives"].get(op, {"by_group": {}})
        by_group = {}
        for g in set(d1["by_group"]) | set(d2["by_group"]):
            b1 = d1["by_group"].get(g, {"bytes": 0, "count": 0})
            b2 = d2["by_group"].get(g, {"bytes": 0, "count": 0})
            by_group[g] = {"bytes": xp(b1["bytes"], b2["bytes"]),
                           "count": xp(b1["count"], b2["count"])}
        coll[op] = {"by_group": by_group,
                    "result_bytes": sum(v["bytes"] for v in by_group.values()),
                    "count": sum(v["count"] for v in by_group.values())}
    return {"cost_x": cost, "collectives_x": coll,
            "probe_raw": [{"cost": c["cost"], "collectives": c["collectives"],
                           "comm_seconds": c["comm_seconds"]}
                          for c in (c1, c2)],
            "comm_seconds_x": (None if None in (c1["comm_seconds"],
                                                c2["comm_seconds"])
                               else xp(c1["comm_seconds"],
                                       c2["comm_seconds"])),
            "n_units": n_units}


def _lower_cell_cfg(cfg: ModelConfig, shape_name: str, *, multi_pod: bool,
                    resident: bool = False, cache_dtype: str = "bf16",
                    serve_bf16: bool = False, lowp: int = 0) -> dict:
    """One cell for an explicit config on the production cube, under the
    serving knobs (``resident``, ``cache_dtype``, ``serve_bf16``: bf16
    serve weights) and the low-precision mode ``lowp`` (set for the
    trace, reset after it)."""
    pes, pods = production_cube(multi_pod)
    layers_mod.LOWP = int(lowp)
    try:
        return _cell(cfg, SHAPES[shape_name], pes, pods, resident=resident,
                     cache_dtype=cache_dtype, serve_bf16=serve_bf16)
    finally:
        layers_mod.LOWP = 0


# ------------------------------------------------------------------ main
def _tag(arch: str, shape: str, mp: bool) -> str:
    return f"{arch}_{shape}_{'multipod' if mp else 'pod'}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="add two-point cost probes to existing cell JSONs")
    ap.add_argument("--profile", default=None, metavar="PROFILE_JSON",
                    help="price the recorded schedule with a tuned "
                         "CommProfile (cells record est_source='measured' "
                         "and comm_seconds)")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from repro_torch.core.planner import install_profile
        from repro_torch.tuning import CommProfile
        profile_ctx = install_profile(CommProfile.load(args.profile))

    archs = list(configs.ALIASES) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.all else [args.multipod]
    os.makedirs(args.out, exist_ok=True)
    with profile_ctx:
        if args.probe:
            return probe_pass(args.out, archs, shapes, meshes)
        return _run_cells(args.out, archs, shapes, meshes)


def _run_cells(out: str, archs, shapes, meshes) -> dict:
    status = {}
    t0 = time.monotonic()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = _tag(arch, shape, mp)
                path = os.path.join(out, tag + ".json")
                if os.path.exists(path):
                    print(f"== {tag}: cached")
                    with open(path) as f:
                        status[tag] = json.load(f).get("status")
                    continue
                print(f"== {tag}", flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod=mp)
                except Exception as e:  # noqa: BLE001 -- record every cell
                    rec = {**_header(arch, shape, mp), "status": "error",
                           "error": repr(e),
                           "trace": traceback.format_exc()[-4000:]}
                    print(rec["trace"])
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status[tag] = rec["status"]
                mem = rec.get("memory", {})
                comm = sum(d["result_bytes"]
                           for d in rec.get("collectives", {}).values())
                print(f"   -> {rec['status']}"
                      + (f" arg {mem['argument_size_in_bytes'] / 1e9:.3f} GB"
                         f" temp {mem['temp_size_in_bytes'] / 1e9:.3f} GB"
                         f" {rec['cost']['flops'] / 1e12:.3f} TFLOP"
                         f" comm {comm / 1e9:.3f} GB"
                         f" {rec['lower_s']} s" if mem else ""), flush=True)
    counts = {s: sum(v == s for v in status.values())
              for s in ("ok", "skipped", "error")}
    print(f"cells: {counts} in {time.monotonic() - t0:.1f} s")
    return status


def probe_pass(out: str, archs, shapes, meshes) -> dict:
    """Add cost probes to already-recorded cells (skips skipped / errored
    ones and those probed)."""
    done = {}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = _tag(arch, shape, mp)
                path = os.path.join(out, tag + ".json")
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    rec = json.load(f)
                if rec.get("status") != "ok" or "cost_x" in rec:
                    continue
                print(f"== probe {tag}", flush=True)
                try:
                    rec.update(run_probe(arch, shape, multi_pod=mp))
                except Exception as e:  # noqa: BLE001 -- record and go on
                    rec["probe_error"] = repr(e)
                    print("   probe failed:", repr(e))
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                done[tag] = "probe_error" not in rec
    return done


if __name__ == "__main__":
    main()
