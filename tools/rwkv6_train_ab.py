#!/usr/bin/env python3
"""The RWKV6 train step of two trees of the repository, in turns on one card.

    python3 tools/rwkv6_train_ab.py --other DIR [--pairs 3] [--layouts 1pe 8pe]

Runs ``chip_smoke._mr_bf16`` (rwkv6-7b at full width, 12 layers, bf16, a
warm-up step and the timed steps through ``Trainer.run``, then one
profiled step) of this checkout and of ``DIR`` (another checkout, e.g.
the parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), each run in a fresh process from its own root, in
the order other, this, this, other, other, this, ... for ``--pairs``
pairs a layout. Prints one JSON line per run (median ms a step, peak GB,
the RWKV6 backward's device ms a step) and a summary per
layout: each tree's median over its runs and the pairs this tree won.
Needs one CUDA card and nvcc; about a minute a run.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r"""
import json, sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
dev = torch.device("cuda")
torch.zeros(1, device=dev)
kept = {k: {} for k in ("flash", "flash_bwd", "reorder", "rwkv6",
                        "rwkv6_bwd")}
r = cs._mr_bf16(dev, "rwkv", sys.argv[1], kept)
p = r["profile"]
print("RESULT " + json.dumps({
    "ok": r["ok"], "ms_per_step": r["ms_per_step"], "step_ms": r["step_ms"],
    "peak_mem_gb": r["peak_mem_gb"],
    "device_busy_ms_per_step": p["device_busy_ms_per_step"],
    "rwkv6_bwd_share_of_device": p["rwkv6_bwd_share_of_device"],
    "rwkv6_bwd_ms_per_step": (p["rwkv6_bwd_share_of_device"]
                              * p["device_busy_ms_per_step"])}))
"""


def run(root: Path, layout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, layout], cwd=root,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{root} {layout}: exit {proc.returncode}\n"
                       f"{proc.stderr[-3000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--layouts", nargs="+", default=["1pe", "8pe"])
    args = ap.parse_args()
    trees = {"other": args.other.resolve(), "this": ROOT}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for layout in args.layouts:
        ms = {"other": [], "this": []}
        for p in range(args.pairs):
            order = ("other", "this") if p % 2 == 0 else ("this", "other")
            for name in order:
                r = run(trees[name], layout)
                ms[name].append(r["ms_per_step"])
                print(json.dumps({"layout": layout, "tree": name,
                                  "pair": p, **r}), flush=True)
        wins = sum(t < o for t, o in zip(ms["this"], ms["other"]))
        print(json.dumps({"layout": layout, "summary": {
            name: {"median_ms": statistics.median(v), "runs": v}
            for name, v in ms.items()}, "this_won_pairs": wins,
            "pairs": args.pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
