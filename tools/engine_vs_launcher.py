#!/usr/bin/env python3
"""The serving engine's step against the launcher's, on one card.

    python3 tools/engine_vs_launcher.py [--pes 1 8] [--turns 3]

Full-width qwen3-1.7b (bf16 over f32 master weights, random from seed 0),
4 requests of 32 prompt tokens and 16 new ones, S_ctx 48: for each PE
count, the launcher's loop (``repro_torch.launch.serve.serve``) and the
``ServeEngine`` on the launcher's prompts (page_size 3) run in turns --
launcher, engine, engine, launcher, launcher, engine for 3 turns -- on one
set of weights, so both sides see the same host. Prints one JSON line per
PE count: each turn's median ms/step, and for the engine the median wall
ms of its ``serve-step`` and ``step-program`` spans (record, lower-cache
lookup, the 9 broadcasts and the gather) from a telemetry ``Tracer``; then
``chip_smoke.profile_steps`` over three engine steps (device busy ms, idle
share, kernels a step), and the card's name and power limit. Needs one
CUDA card and nvcc (the flash kernel is built first).
"""
import argparse
import gc
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs, telemetry  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.serving import make_serve_plan  # noqa: E402
from repro_torch.models.topology import build_serve_topology  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402


def turns(n: int) -> list:
    """launcher, engine, engine, launcher, ... : n of each, in pairs that
    alternate which side runs first."""
    out = []
    for i in range(n):
        out += ["launcher", "engine"] if i % 2 == 0 else ["engine",
                                                          "launcher"]
    return out


def cell(cfg, pes: int, n_turns: int, dev) -> dict:
    topo = build_serve_topology(cfg, pes)
    plan = make_serve_plan(cfg, topo, S_ctx=cs.PROMPT + cs.GEN,
                           global_batch=cs.BATCH)
    params = init_params(cfg, topo, 0, device=dev)

    def engine():
        return ServeEngine(cfg, topo, plan, params,
                           page_size=cs.ENGINE_PAGE, device=dev)

    prompts, rows = None, []
    for turn in ["launcher"] + turns(n_turns):
        if turn == "launcher":
            run = serve(cs.ARCH, batch=cs.BATCH, prompt_len=cs.PROMPT,
                        gen=cs.GEN, pes=pes, device=dev, seed=0,
                        params=params)
            if prompts is None:         # the first run only fixes prompts
                prompts = run["tokens"][:, :cs.PROMPT].tolist()
                continue
            rows.append({"turn": turn, "ms_per_step": run["ms_per_step"]})
            continue
        eng = engine()
        reqs = [Request(rid=b, prompt=p, max_new=cs.GEN)
                for b, p in enumerate(prompts)]
        with telemetry.Tracer() as tr:
            eng.run(reqs)
        spans: dict = {}
        for sp in tr.finished():
            spans.setdefault(sp.name, []).append(sp.dur / 1e3)
        rows.append({
            "turn": turn,
            "ms_per_step": eng.metrics.quantile("serve.step_seconds",
                                                0.5) * 1e3,
            "serve_step_ms": statistics.median(spans["serve-step"]),
            "step_program_ms": statistics.median(spans["step-program"]),
            "step_program_first_ms": spans["step-program"][0]})
    eng = engine()
    for b, p in enumerate(prompts):
        eng.submit(Request(rid=b, prompt=p, max_new=cs.GEN))
    return {"pes": pes, "rows": rows,
            "profile": cs.profile_steps(lambda t: eng.step())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pes", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("engine_vs_launcher: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_build()
    cfg = configs.get(cs.ARCH)
    for pes in args.pes:
        print(json.dumps(cell(cfg, pes, args.turns, dev)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
