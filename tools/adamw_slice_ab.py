#!/usr/bin/env python3
"""AdamW's sliced update against the whole-leaf update, on one card.

    python3 tools/adamw_slice_ab.py [--layouts 1pe 8pe] [--rounds 2]

Full-width qwen3-1.7b training (``chip_smoke.py``'s ``train`` cell: bf16
over f32 masters, int8 moments, 4 x 1,024 tokens from TokenStream, random
masters from seed 0) through ``Trainer`` with ``adamw.SLICE_ELEMS`` at
2^27 ("sliced", the source) and at 2^40 ("whole": no leaf is sliced, the
update as it was before slicing), run in the order sliced, whole, whole,
sliced in each round, one run at a time on the card. Each run takes a
warm-up step and ``chip_smoke.TRAIN_TIMED`` timed steps and reports their
median ms/step, the peak memory, and the median span of ``adamw.update``
a step between CUDA events (device clock: the host's launch gaps inside
the update count). Prints one JSON line per layout with every run, then
the card's name and power limit. Needs one CUDA card and nvcc (the flash
kernels are built first).
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
from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    Trainer, TrainConfig, place_batch)

SLICES = {"sliced": 1 << 27, "whole": 1 << 40}


def timed_update(spans: list):
    """``adamw.update`` wrapped between two CUDA events; each call's pair
    goes to ``spans``."""
    update = adamw.update

    def timing(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = update(*args, **kw)
        end.record()
        spans.append((start, end))
        return out
    return update, timing


def run(dev, layout: str, mode: str) -> dict:
    adamw.SLICE_ELEMS = SLICES[mode]
    tc = TrainConfig(lr=cs.TRAIN_LR, warmup=cs.TRAIN_WARMUP, total_steps=100)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, topo, masters, opt = cs._train_setup(dev, layout, tc)
    stream = TokenStream(cfg, DataConfig(seq_len=cs.TRAIN_SEQ,
                                         global_batch=cs.TRAIN_BATCH,
                                         vocab_size=cfg.vocab_size))
    trainer = Trainer(cfg, topo, tc)
    spans = []
    update, timing = timed_update(spans)
    adamw.update = timing
    try:
        for s in range(1 + cs.TRAIN_TIMED):
            batch = place_batch(stream.global_batch_at(s), cfg, topo, dev)
            masters, opt, _ = trainer.run(masters, opt, [batch],
                                          log_every=0)
        torch.cuda.synchronize(dev)
    finally:
        adamw.update = update
    step_ms = [t * 1e3 for t in trainer.step_seconds]
    update_ms = [a.elapsed_time(b) for a, b in spans]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del masters, opt, trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"mode": mode, "slice_elems": SLICES[mode],
            "ms_per_step": statistics.median(step_ms[1:]),
            "step_ms": step_ms,
            "update_ms": statistics.median(update_ms[1:]),
            "update_ms_all": update_ms, "peak_mem_gb": peak}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", nargs="+", default=["1pe", "8pe"],
                    choices=sorted(cs.TRAIN_LAYOUTS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adamw_slice_ab: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)          # the memory stats need a context
    build = cs.phase_build()
    if build.get("spilling"):
        print(f"adamw_slice_ab: spills {build['spilling']}", file=sys.stderr)
        return 1
    order = ["sliced", "whole", "whole", "sliced"]
    for layout in args.layouts:
        runs = [run(dev, layout, mode) for _ in range(args.rounds)
                for mode in order]
        summary = {m: {k: statistics.median(r[k] for r in runs
                                            if r["mode"] == m)
                       for k in ("ms_per_step", "update_ms", "peak_mem_gb")}
                   for m in SLICES}
        print(json.dumps({"layout": layout, "summary": summary,
                          "runs": runs}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
