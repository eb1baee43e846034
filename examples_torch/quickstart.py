"""Quickstart on the port: the PID-Comm communicator API in five minutes.

Builds a 2x2x2 virtual hypercube of 8 PEs (held in one process: every
tensor carries the cube's axes first), binds communicators to dim
selections (``cube.comm``), runs multi-instance collectives over cube
slices (paper Fig. 5), sweeps the Table II algorithm stages, lets
planner-driven ``algorithm="auto"`` dispatch pick the §IX-A hierarchical
flow on a pod-crossing all-reduce -- with every dispatch observed by a
:class:`CommTrace` -- and records a deferred ``cube.program()`` whose
lowering fuses a reduce_scatter+all_gather chain into one all_reduce.
Section 7 tunes the flows on the device and section 8 prices a program's
overlap from the tuned profile. Section 9 walks the backward-overlapped
gradient sync: reverse-layer bucket programs fired inside backward from
autograd hooks, bit-identical to the barrier path. Section 10 runs the
continuous-batching serve engine (paged KV cache + one recorded
CommProgram per decode step) through an admit -> prefill -> decode ->
evict request lifecycle. Section 11 races the collective-fused kernels
(repro_torch.kernels.collective): a measured profile steers a recorded
program's all_gather onto the ring_fused flow, bit-identically. Section 12
captures one span timeline with the metrics registry and a drift monitor;
section 13 saves a checkpoint on the cube and restores it onto a ring.

    python3 examples_torch/quickstart.py [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (it raises when no GPU is
visible). Set ``QUICKSTART_SUMMARY=/path.json`` to dump the CommTrace
summaries. The counterpart of ``examples/quickstart.py``.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import warnings
from pathlib import Path

# the repository's src/, for python3 examples_torch/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs, resolve_device, telemetry  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, TrainState  # noqa: E402
from repro_torch.core.comm import CommTrace  # noqa: E402
from repro_torch.core.hypercube import Hypercube  # noqa: E402
from repro_torch.core.planner import install_profile, plan  # noqa: E402
from repro_torch.core.program import LOWER_STATS  # noqa: E402
from repro_torch.models.params import flat_leaves, init_params  # noqa: E402
from repro_torch.models.serving import make_serve_plan  # noqa: E402
from repro_torch.models.topology import build_serve_topology  # noqa: E402
from repro_torch.runtime.overlap import with_backward_bucket_sync  # noqa: E402
from repro_torch.runtime.trainer import sync_replicated_grads  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.tuning import (CommProfile, LinkModel, Tuner,  # noqa: E402
                                topology_fingerprint)


def _est(seconds, unit: str = "us") -> str:
    """An estimate in us or ms; the port's planner leaves a flow it has no
    measured profile for unpriced (None)."""
    if seconds is None:
        return "unpriced"
    return f"{seconds * (1e6 if unit == 'us' else 1e3):.2f}{unit}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    f32 = dict(dtype=torch.float32, device=dev)

    # 1. define a virtual hypercube of 8 PEs (paper §IV-B): dims are
    #    user-chosen, PEs numbered major -> minor.
    cube = Hypercube.build({"x": 2, "y": 2, "z": 2})
    print("cube:", cube.describe(), f"({dev})")

    # 2. bind a communicator to a dim selection: the bitmap "010" selects
    #    the y dimension -> four independent AllReduce instances run at
    #    once. The handle caches group size / instance count / ICI-DCN
    #    split once.
    ar_y = cube.comm("010")
    print("comm:", ar_y.describe())
    x = torch.arange(8.0 * 6, **f32).reshape(2, 2, 2, 6)   # (*cube, 6)
    out = ar_y.all_reduce(x)
    assert torch.equal(out, x.sum(1, keepdim=True).expand_as(x))
    print("AllReduce along y (4 instances):", tuple(out.shape))

    # 3. AlltoAll over the (x, z) plane -- 2 instances of group size 4
    #    (the DLRM embedding exchange of paper Fig. 11).
    aa_xz = cube.comm(("x", "z"))
    out = aa_xz.all_to_all(torch.ones(2, 2, 2, 8, **f32), split_axis=0,
                           concat_axis=0)
    print("AlltoAll over (x,z):", tuple(out.shape))

    # 4. algorithm stages (paper Fig. 16 ablation): naive -> pr -> im -> cm;
    #    "auto" asks the planner, "pidcomm" takes the strongest Table II
    #    stage.
    aa_z = cube.comm("001")
    for alg in ("naive", "pr", "im", "pidcomm", "auto"):
        out = aa_z.all_to_all(torch.ones(2, 2, 2, 8, **f32), split_axis=0,
                              concat_axis=0, algorithm=alg)
        print(f"  all_to_all[{alg:8s}] ok, shape {tuple(out.shape)}")

    # 5. plan-driven dispatch across pods: on a pod-crossing gradient
    #    AllReduce the planner picks the hierarchical §IX-A split (ICI
    #    reduce-scatter -> DCN all-reduce of the 1/|ICI| shard -> ICI
    #    all-gather), and that is what algorithm="auto" executes. CommTrace
    #    records each dispatch with the chosen flow/stage and the estimated
    #    ICI/DCN bytes and seconds.
    prod = Hypercube.build({"pod": 2, "dp": 2, "tp": 2})
    grad_ar = prod.comm(("pod", "dp"))
    est = plan(prod, "all_reduce", ("pod", "dp"), 64 * 2**20)
    print(f"plan: {est.algorithm} via {est.schedule}; "
          f"ICI {est.ici_bytes/2**20:.0f} MiB, "
          f"DCN {est.dcn_bytes/2**20:.0f} MiB, est {_est(est.seconds, 'ms')}")
    g = torch.ones(2, 2, 2, 64, **f32)
    with CommTrace() as trace:
        out = grad_ar.all_reduce(g)
    for ev in trace.events:
        print(f"traced: {ev.primitive}[{ev.bitmap}] -> {ev.flow} "
              f"(stage {ev.stage}, g={ev.group_size}x{ev.num_instances}inst, "
              f"ICI {ev.ici_bytes:.0f}B, DCN {ev.dcn_bytes:.0f}B, "
              f"est {_est(ev.seconds)})")
    assert trace.events and trace.events[0].flow == "hierarchical"
    print("auto dispatch executed the planner's hierarchical pick")

    # 6. deferred programs (record -> optimize -> execute): the
    #    reduce_scatter + all_gather pair (the two halves of a gradient sync
    #    written out by hand) is recorded as a CommProgram, and lower()
    #    fuses it into ONE all_reduce, which on the pod-crossing group
    #    executes the hierarchical split. CommTrace.summary() shows the
    #    provenance: one event, fused from two recorded ops.
    with grad_ar.program(name="quickstart-fuse") as prog:
        a = prog.input(torch.empty(2, 2, 2, 64, **f32))
        shard = grad_ar.reduce_scatter(a, axis=0)
        full = grad_ar.all_gather(shard, axis=0)
        prog.output(full)
    lowered = prog.lower()
    print(lowered.describe())
    assert len(lowered.ops) == 1 and lowered.ops[0].fused_from == (0, 1)
    with CommTrace() as ptrace:
        out2 = lowered.execute(g)
    assert torch.equal(out2, out)
    summary = ptrace.summary()
    print("program trace summary:", summary)
    assert summary["fused_events"] == 1 and summary["events"] == 1
    assert summary["programs"] == ["quickstart-fuse"]
    print("record->optimize->execute: rs+ag fused into one hierarchical "
          "all_reduce, bit-identical to the eager result")

    # 7. autotuning (measure -> fit -> plan): a Tuner microbenchmarks the
    #    registered flows on the device, fits per-(flow, stage, domain)
    #    alpha-beta models, and persists them as a fingerprint-keyed
    #    CommProfile. Installing the profile makes algorithm="auto"
    #    dispatch on *measured* data -- every CommEvent (and
    #    CommTrace.summary()) then carries est_source="measured".
    tune_dir = tempfile.mkdtemp(prefix="repro-tuning-")
    ckpt_dir = tempfile.mkdtemp(prefix="quickstart-ckpt-")
    try:
        tuner = Tuner(cache_dir=tune_dir, device=dev)
        prof = tuner.tune(cube, sizes=(16 * 1024, 64 * 1024),
                          primitives=("all_reduce", "all_to_all"),
                          reps=2, warmup=1)
        print("tuned:", prof.describe())
        prof = tuner.load(cube)        # reload: fingerprint-checked
        with install_profile(prof), CommTrace() as ttrace:
            ar_y.all_reduce(x)
        tuned_summary = ttrace.summary()
        print("tuned trace summary:", tuned_summary)
        assert ttrace.events[0].est_source == "measured"
        assert tuned_summary["est_sources"] == {"measured": 1}
        print("auto dispatch priced from the measured CommProfile "
              f"(flow {ttrace.events[0].flow}, "
              f"est {ttrace.events[0].seconds * 1e6:.1f}us measured)")

        # 8. overlap-aware program scheduling: the tune() above also ran
        #    the overlap sweep -- pairs of collectives dispatched
        #    back-to-back vs alone -- fitting per-domain-pair serialization
        #    factors into the profile. With the profile installed,
        #    plan_program prices a multi-op program's interleaving order
        #    and its seconds-vs-serial budget from those measurements.
        #    Structurally identical recordings reuse one cached lowered
        #    schedule (the trainer's per-step grad sync rides this cache).
        print("overlap factors:",
              {k: round(m.factor, 3) for k, m in prof.overlap.items()})

        def record_pair():
            pair = cube.program(name="quickstart-overlap")
            with pair:
                a = pair.input(torch.empty(2, 2, 2, 64, **f32))
                b = pair.input(torch.empty(2, 2, 2, 64, **f32))
                pair.output(ar_y.all_reduce(a), aa_z.all_gather(b, axis=0))
            return pair

        with install_profile(prof):
            lowered_pair = record_pair().lower()
            stats0 = dict(LOWER_STATS)
            record_pair().lower()       # identical structure: cache hit
        print(lowered_pair.describe())
        oplan = lowered_pair.plan
        assert oplan.est_source == "measured"
        assert oplan.seconds <= oplan.serial_seconds + 1e-12
        assert LOWER_STATS["cache_hits"] > stats0["cache_hits"]
        print(f"overlap-aware plan: {oplan.seconds*1e6:.1f}us vs serial "
              f"{oplan.serial_seconds*1e6:.1f}us "
              f"(est_source={oplan.est_source}); re-recording reused the "
              "cached lowered program")

        # 9. backward-overlapped gradient sync: the trainer's barrier path
        #    runs backward to completion and then executes ONE coalesced
        #    grad-sync program. The overlapped path (runtime.overlap)
        #    partitions the replicated gradients into reverse-layer buckets
        #    and fires each bucket's program *inside* backward from an
        #    autograd hook: the loss head's gradients are backward's first
        #    outputs, so its bucket (grad-sync-b0) dispatches while the rest
        #    of backward still computes. Grads stay bit-identical to the
        #    barrier path.
        pd = prod.dim_names

        def toy_tree():
            # embed sharded over every dim (no sync needed), the trunk
            # and the loss head replicated: (*cube, per-PE block)
            return {"embed": torch.ones(2, 2, 2, 1, 4, **f32),
                    "units": {"w": torch.ones(2, 2, 2, 2, 16, **f32)},
                    "lm_head": torch.ones(2, 2, 2, 4, 16, **f32)}
        tspecs = {"embed": (pd, None), "units": {"w": (None, None)},
                  "lm_head": (None, None)}

        def toy_loss(p, b):
            # consume groups in forward order (embed -> trunk -> head),
            # like a real model: backward then produces the head gradients
            # first
            h = p["embed"].square().sum() + 0.0 * b
            h = h + p["units"]["w"].square().sum()
            h = h + p["lm_head"].square().sum()
            return h, {}

        def grads_of(p):
            return {"embed": p["embed"].grad,
                    "units": {"w": p["units"]["w"].grad},
                    "lm_head": p["lm_head"].grad}

        def barrier_grads(b):
            p = toy_tree()
            for leaf in flat_leaves(p):
                leaf.requires_grad_()
            toy_loss(p, b)[0].backward()
            return sync_replicated_grads(grads_of(p), tspecs, prod)

        b9 = torch.tensor(1.0, **f32)
        tree = toy_tree()
        for leaf in flat_leaves(tree):
            leaf.requires_grad_()
        hooked_loss = with_backward_bucket_sync(toy_loss, tspecs, prod)
        with CommTrace() as btrace:
            (loss9, _), sync = hooked_loss(tree, b9)
            loss9.backward()
        g_ov = sync.grads()
        g_bar = barrier_grads(b9)
        bucket_order = [ev.program_id for ev in btrace.events
                        if ev.program_id
                        and ev.program_id.startswith("grad-sync-b")]
        overlap_summary = btrace.summary()
        print("backward-overlap trace summary:", overlap_summary)
        print("bucket dispatch order during backward:", bucket_order)
        for want, got in zip(flat_leaves(g_bar), flat_leaves(g_ov)):
            assert torch.equal(want, got)
        # head bucket first, trunk second; the fully-sharded embed leaf
        # never records a program at all
        assert bucket_order == ["grad-sync-b0", "grad-sync-b1"]
        assert overlap_summary["programs"] == ["grad-sync-b0",
                                               "grad-sync-b1"]
        print("backward-overlapped sync: bucket programs fired in "
              "reverse-layer order during backward, bit-identical to the "
              "barrier sync")

        # 10. production decode serving (repro_torch.serving): a paged KV
        #     cache under a continuous-batching engine. One request's
        #     lifecycle: it ADMITS from the arrival queue into a free batch
        #     lane, PREFILLS through the flash kernel's decode form
        #     (teacher-forcing each prompt token into the paged cache),
        #     DECODES with on-device sampling until its length budget is
        #     spent, and EVICTS, returning its pages to the pools. Every
        #     step's host<->PE control traffic is ONE recorded CommProgram,
        #     so after the first step every lowering is a fingerprint-cache
        #     hit.
        cfg = configs.get("qwen3-1.7b").scaled_for_smoke()
        stopo = build_serve_topology(cfg, 1)
        splan = make_serve_plan(cfg, stopo, S_ctx=24, global_batch=2)
        engine = ServeEngine(cfg, stopo, splan,
                             init_params(cfg, stopo, 0, device=dev),
                             page_size=4, device=dev)
        reqs = [Request(rid=0, prompt=[3, 1, 4, 1, 5], max_new=4),
                Request(rid=1, prompt=[2, 7, 1], max_new=6, arrival=2)]
        sstats0 = dict(LOWER_STATS)
        with CommTrace() as strace:
            serve_metrics = engine.run(reqs)
        serve_summary = strace.summary()
        print("serving trace summary:", serve_summary)
        for r in serve_metrics["finished"]:
            print(f"  request {r.rid}: admitted step {r.admitted_step}, "
                  f"prefill {r.plen} toks, decoded {r.out_tokens}, evicted "
                  f"after step {r.finished_step}")
        assert "serve-step" in serve_summary["programs"]
        assert serve_metrics["programs_recorded"] == serve_metrics["steps"]
        assert (LOWER_STATS["cache_hits"] - sstats0["cache_hits"]
                >= serve_metrics["steps"] - 1)
        print(f"served {len(serve_metrics['finished'])} requests in "
              f"{serve_metrics['steps']} steps at "
              f"{serve_metrics['tokens_per_s']:.0f} tok/s; the per-step "
              "program lowered once and hit the fingerprint cache every "
              "step after")

        # 11. collective-fused kernels (repro_torch.kernels.collective):
        #     ring-rotation flows registered in the same algorithm registry
        #     as the Table II stages, so they trace, price, and race under
        #     algorithm="auto". A measured CommProfile that prices the fused
        #     ring cheaper flips a recorded program's joint plan onto
        #     ring_fused; the movement itself is bit-identical.
        fast = LinkModel(alpha=0.0, beta=1e-12, n=8, r2=1.0)
        slow = LinkModel(alpha=1.0, beta=1e-6, n=8, r2=1.0)
        fused_prof = CommProfile(topology_fingerprint(cube, dev), models={
            "ring_fused/cm/ici": fast, "rs_epilogue/cm/ici": fast,
            "naive/naive/ici": slow, "direct/im/ici": slow,
            "direct/cm/ici": slow})
        ag_z = cube.comm("001")
        with ag_z.program(name="quickstart-fused") as fprog:
            a = fprog.input(torch.empty(2, 2, 2, 16, **f32))
            fprog.output(ag_z.all_gather(a, axis=0))
        fx = torch.ones(2, 2, 2, 16, **f32)
        with install_profile(fused_prof):
            flow_lowered = fprog.lower()
            fest = next(iter(flow_lowered.plan.estimates.values()))
            assert fest.algorithm == "ring_fused", fest
            assert fest.est_source == "measured"
            with CommTrace() as ftrace:
                fout = flow_lowered.execute(fx)
        fused_summary = ftrace.summary()
        print("fused-kernel trace summary:", fused_summary)
        assert [ev.flow for ev in ftrace.events] == ["ring_fused"]
        # same blocks, same bytes, same bits
        assert torch.equal(fout, ag_z.all_gather(fx, axis=0,
                                                 algorithm="pidcomm"))
        print("measured profile steered the recorded program onto the "
              f"fused ring flow (est {fest.seconds * 1e6:.2f}us measured), "
              "bit-identical to the Table II gather")

        # 12. unified telemetry (repro_torch.telemetry): one Tracer
        #     captures a span timeline across a train step and the serving
        #     engine. While the tracer is active every live CommEvent
        #     becomes a child span under whatever span is open, and
        #     lower-cache hits annotate the timeline as instant marks. The
        #     metrics registry counts what the narrative above only
        #     printed, and a drift monitor catches a synthetically
        #     mis-scaled profile: the fused ring's real wall time sits far
        #     outside the band around the profile's (absurdly fast)
        #     estimate, so exactly one structured ProfileStalenessWarning
        #     names the stale (flow, stage, domain).
        engine.reset_metrics()           # warmup boundary: fresh registry
        steps_before12 = engine.step_idx  # run() reports cumulative steps
        telemetry.enable_metrics()
        try:
            with telemetry.Tracer() as tracer:
                with tracer.span("train-step", cat="wall"):
                    barrier_grads(b9)    # the step's grad-sync dispatches
                req12 = Request(rid=9, prompt=[6, 2, 8, 3], max_new=3,
                                arrival=engine.step_idx)
                serve12 = engine.run([req12])
        finally:
            telemetry.disable_metrics()
        chrome = json.loads(tracer.chrome_trace_json())
        evs = chrome["traceEvents"]
        serve_spans = [e for e in evs if e.get("name") == "serve-step"]
        prog_children = [e for e in evs if e.get("cat") == "comm"
                         and e["args"].get("program_id") == "serve-step"]
        assert serve_spans, "each engine decode step opens a serve-step span"
        assert prog_children, "the step program's ops land as comm spans"
        assert all("est_source" in e["args"] and "fused_from" in e["args"]
                   for e in prog_children)
        assert any(e.get("name") == "lower-cache-hit" for e in evs), \
            "warm-cache lowerings annotate the timeline"
        snap = telemetry.REGISTRY.snapshot()
        steps12 = serve12["steps"] - steps_before12
        assert telemetry.REGISTRY.value("comm.dispatches") > 0
        assert telemetry.REGISTRY.value("program.lower_cache_hits") \
            >= steps12
        assert engine.metrics.value("serve.steps") == steps12
        assert serve12["p50_token_s"] == engine.metrics.quantile(
            "serve.token_seconds", 0.50)
        hit_marks = sum(e.get("name") == "lower-cache-hit" for e in evs)
        print(f"telemetry: {len(serve_spans)} serve-step spans, "
              f"{len(prog_children)} per-op child spans with provenance, "
              f"{hit_marks} lower-cache-hit marks; engine registry is the "
              "measurement path")

        mon = telemetry.DriftMonitor(min_samples=1)   # judge on first
        t12 = time.perf_counter()
        with install_profile(fused_prof):
            fo = flow_lowered.execute(fx)
            if fo.is_cuda:
                torch.cuda.synchronize(fo.device)
        wall12 = time.perf_counter() - t12
        with warnings.catch_warnings(record=True) as wlist:
            warnings.simplefilter("always")
            for ev in ftrace.events:     # measured, priced ~0 by fused_prof
                mon.observe_event(ev, measured_s=wall12)
        stale = [w.message for w in wlist if isinstance(
            w.message, telemetry.ProfileStalenessWarning)]
        assert len(stale) == 1, "exactly one structured warning a stale key"
        sw = stale[0]
        assert (sw.flow, sw.stage, sw.domain) == ("ring_fused", "cm", "ici")
        assert "Tuner" in sw.recipe or "tune" in sw.recipe.lower()
        print(f"drift monitor flagged ({sw.flow}, {sw.stage}, {sw.domain}): "
              f"median meas_over_est={sw.median:.3g} outside "
              f"[{sw.band[0]:g}, {sw.band[1]:g}] -- {sw.recipe}")

        # 13. elastic checkpointing (repro_torch.checkpoint): save from the
        #     2x2x2 cube -- one recorded rooted-gather program per section;
        #     the second save's structural fingerprint matches the first,
        #     so it hits the lower cache -- then restore the same
        #     checkpoint onto a 1-D ring of the same 8 PEs through a
        #     rooted-scatter program planned for THAT cube. Same global
        #     bits, different placement: the forward on the ring is
        #     bit-identical.
        wspec = {"w": ("x", ("y", "z")), "b": (("x", "y"), None)}
        host_w = {"w": torch.arange(64.0, **f32).reshape(8, 8),
                  "b": torch.arange(32.0, **f32).reshape(8, 4)}
        placed_w = {k: cube.to_cube(v, wspec[k]) for k, v in host_w.items()}
        saver = CheckpointManager(ckpt_dir, topo=cube, async_save=False,
                                  device=dev,
                                  specs={"params": wspec, "opt": None})
        hits_before = LOWER_STATS["cache_hits"]
        saver.save(1, TrainState(params=placed_w))
        saver.save(2, TrainState(params=placed_w))
        ckpt_cache_hits = LOWER_STATS["cache_hits"] - hits_before
        assert ckpt_cache_hits >= 1, "second save must reuse the lowering"

        ring = Hypercube.build({"r": 8})      # elastic: a different cube
        rspec = {"w": ("r", None), "b": ("r", None)}
        loader = CheckpointManager(ckpt_dir, topo=ring, device=dev,
                                   specs={"params": rspec, "opt": None})
        with CommTrace() as ckpt_trace:
            restored = loader.restore_params(2)
        ckpt_summary = ckpt_trace.summary()
        assert "ckpt-restore-params" in ckpt_summary["programs"]
        assert tuple(restored["w"].shape) == (8, 1, 8)     # (r, 8 / 8, 8)
        ring_w = ring.from_cube(restored["w"], rspec["w"])
        ring_b = ring.from_cube(restored["b"], rspec["b"])
        assert torch.equal(ring_w @ ring_b, host_w["w"] @ host_w["b"])
        print("elastic restore: saved on {x,y,z}=2x2x2, restored onto "
              f"{{r}}=8 via a planned scatter program ({ckpt_cache_hits} "
              "save lower-cache hits); ring forward bit-identical to the "
              "host reference")
    finally:
        shutil.rmtree(tune_dir)
        shutil.rmtree(ckpt_dir)

    result = {
        "eager": trace.summary(), "program": summary,
        "tuned": tuned_summary,
        "overlap_plan": {"seconds": oplan.seconds,
                         "serial_seconds": oplan.serial_seconds,
                         "est_source": oplan.est_source,
                         "order": list(oplan.order)},
        "backward_overlap": {"bucket_order": bucket_order,
                             "summary": overlap_summary},
        "fused_kernels": {"summary": fused_summary,
                          "flow": ftrace.events[0].flow,
                          "est_source": ftrace.events[0].est_source},
        "serving": {"summary": serve_summary,
                    "steps": serve_metrics["steps"],
                    "tokens_per_s": serve_metrics["tokens_per_s"],
                    "programs_recorded": serve_metrics["programs_recorded"]},
        "checkpoint": {"summary": ckpt_summary,
                       "save_lower_cache_hits": ckpt_cache_hits,
                       "restore_programs": ckpt_summary["programs"]},
        "telemetry": {"serve_step_spans": len(serve_spans),
                      "comm_child_spans": len(prog_children),
                      "lower_cache_hit_marks": hit_marks,
                      "metrics": {k: snap[k] for k in sorted(snap)},
                      "stale": mon.summary()["stale"]}}
    if os.environ.get("QUICKSTART_SUMMARY"):
        out_dir = os.path.dirname(os.environ["QUICKSTART_SUMMARY"]) or "."
        with open(os.path.join(out_dir, "quickstart_chrome_trace.json"),
                  "w") as f:
            f.write(tracer.chrome_trace_json())
        with open(os.path.join(out_dir, "quickstart_metrics.json"),
                  "w") as f:
            json.dump({"global": snap, "engine": engine.metrics.snapshot(),
                       "drift": mon.summary()}, f, indent=1)
        with open(os.environ["QUICKSTART_SUMMARY"], "w") as f:
            json.dump(result, f, indent=1, default=str)
        print("wrote", os.environ["QUICKSTART_SUMMARY"],
              "quickstart_chrome_trace.json quickstart_metrics.json")
    return result


if __name__ == "__main__":
    main()
