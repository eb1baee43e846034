"""Continuous-batching decode serving on the PE hypercube, on the port: a
Poisson arrival trace of mixed-length requests served by
``repro_torch.serving`` -- paged KV cache (per-shard page pools,
per-request page table), admission / eviction / slot reuse per decode
step, teacher-forced prefill through the flash kernel's decode form,
on-device sampling, and ONE recorded CommProgram of rooted collectives per
step, lowered once and served from the structural-fingerprint cache ever
after.

    python3 examples_torch/serve_decode.py [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (it raises when no GPU is
visible). The counterpart of ``examples/serve_decode.py``: the same model,
cube, trace and asserts; the 8 PEs are the port's virtual cube, held in
one process on one device.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

# the repository's src/, for python3 examples_torch/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs, resolve_device  # noqa: E402
from repro_torch.core.program import LOWER_STATS  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.serving import make_serve_plan  # noqa: E402
from repro_torch.models.topology import build_serve_topology  # noqa: E402
from repro_torch.serving import ServeEngine, poisson_trace  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get("qwen3-1.7b").scaled_for_smoke()
    # serve on all 8 PEs: maximal model sharding, batch replicated
    cfg = dataclasses.replace(cfg, tp=8)
    topo = build_serve_topology(cfg, 8)
    B, S_ctx = 4, 48
    plan = make_serve_plan(cfg, topo, S_ctx=S_ctx, global_batch=B)
    params = init_params(cfg, topo, 0, device=dev)
    # S_cache 48 over 8 shards = 6 slots/shard -> 3-slot pages, 2 per shard
    engine = ServeEngine(cfg, topo, plan, params, page_size=3, seed=0,
                         device=dev)
    print(f"serving {cfg.name} on {topo.cube.describe()} ({dev}); "
          f"{B} lanes x {plan.S_cache} slots in "
          f"{engine.pplan.pages_per_shard}-page pools "
          f"({engine.pplan.page_size} slots/page, "
          f"{engine.pplan.n_shards} shards)")

    # mixed request lengths under Poisson arrivals -- more requests than
    # lanes, so lanes are reused as requests complete (continuous batching)
    trace = poisson_trace(10, rate=1.5, plen_range=(5, 16),
                          max_new_range=(4, 10), vocab=cfg.vocab_size,
                          seed=7)
    before = dict(LOWER_STATS)
    metrics = engine.run(trace)
    hits = LOWER_STATS["cache_hits"] - before["cache_hits"]
    lowered = LOWER_STATS["lowered"] - before["lowered"]

    print(f"{metrics['steps']} engine steps in {metrics['wall_s']:.1f}s: "
          f"{metrics['generated_tokens']} tokens at "
          f"{metrics['tokens_per_s']:.1f} tok/s "
          f"(p50 {metrics['p50_token_s'] * 1e3:.1f} ms/tok, "
          f"p99 {metrics['p99_token_s'] * 1e3:.1f} ms/tok)")
    print(f"per-step programs: {metrics['programs_recorded']} recorded, "
          f"{lowered} lowered, {hits} fingerprint-cache hits")
    assert lowered == 1 and hits >= metrics["steps"] - 1
    assert len(metrics["finished"]) == len(trace)
    for r in sorted(metrics["finished"], key=lambda r: r.rid):
        assert len(r.out_tokens) == r.max_new
        print(f"request {r.rid} (arrived {r.arrival:2d}, prompt "
              f"{r.plen:2d}): steps {r.admitted_step}-{r.finished_step} -> "
              f"{r.out_tokens[:8]}")
    return {"steps": metrics["steps"], "lowered": lowered, "hits": hits,
            "requests": len(trace), "finished": len(metrics["finished"]),
            "generated_tokens": metrics["generated_tokens"],
            "tokens_per_s": metrics["tokens_per_s"],
            "wall_s": metrics["wall_s"],
            "out_tokens": {r.rid: list(r.out_tokens)
                           for r in metrics["finished"]}}


if __name__ == "__main__":
    main()
