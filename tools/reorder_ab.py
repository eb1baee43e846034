#!/usr/bin/env python3
"""The reorder kernel of two trees of the repository, in turns on one card.

    python3 tools/reorder_ab.py --other DIR [--pairs 2]

Builds the reorder library of this checkout and of ``DIR`` (another
checkout, e.g. the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists), both ``nvcc`` runs started together,
and prints each build's ptxas register and spill lines. Then times
``reorder.tile_swizzle`` on each shape of ``ROWS`` (the main path's
all_to_alls and K/V reshards, and ``chip_smoke.REORDER_SWEEP``'s block
sizes at about 64 MiB of payload; a random perm from seed 0 each) with
``chip_smoke.time_ms`` (20 calls in a CUDA graph replayed 10 times between
CUDA events) in a fresh process from each tree's root, in the order other,
this, this, other, ... for ``--pairs`` pairs, and checks every launch bit
for bit against the plain version (``ref.tile_swizzle``). Prints one JSON
line per run and a summary: each tree's median ms per shape, the change's
ratio to the other's, and the bytes bound. Needs one CUDA card and nvcc;
about 20 s for the builds and 15 s a run.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12

# name: (dtype, blocks, columns): x (blocks, columns), one-row blocks
ROWS = {
    "moe_decode_8pe": ("bfloat16", 512, 2048),
    "dlrm_aa_xyz": ("float32", 16384, 208),
    "moe_train_ep8": ("bfloat16", 512, 81920),
    "qwen3_reshard_8pe": ("bfloat16", 132096, 128),
    "mixtral_decode_8pe": ("bfloat16", 64, 8192),
    "mixtral_train_ep8": ("bfloat16", 64, 655360),
    "whisper_reshard_8pe": ("bfloat16", 3072, 64),
    "llava_reshard_8pe": ("bfloat16", 193536, 128),
    "jamba_decode_8pe": ("bfloat16", 128, 16384),
    "jamba_train_ep8": ("bfloat16", 128, 163840),
    "launch_floor": ("bfloat16", 1, 8),
    **{f"sweep_{b}B": ("bfloat16", 64 * 2 ** 20 // b, b // 2)
       for b in (16, 128, 256, 832, 4096, 32768, 163840, 1310720)},
}

RUN = r"""
import json, sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
from repro_torch.kernels.reorder import ref, reorder
rows = json.loads(sys.argv[1])
dev = torch.device("cuda")
out = {}
for name, (dt, G, D) in rows.items():
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((G, D), generator=gen, device=dev).to(getattr(torch, dt))
    perm = torch.randperm(G, generator=gen, device=dev).to(torch.int32)
    got = reorder.tile_swizzle(x, perm)
    want = ref.tile_swizzle(x, perm)
    ok = bool(torch.equal(cs._bits(got), cs._bits(want)))
    out[name] = {"ms": cs.time_ms(lambda: reorder.tile_swizzle(x, perm)),
                 "ok": ok}
    del x, got, want
print("RESULT " + json.dumps(out))
"""

BUILD = r"""
import json, sys
sys.path[:0] = [".", "src"]
from repro_torch.kernels import _build
log = _build.build_all(["reorder"])["reorder"]
entry, lines, spills = None, [], []
for ln in log.splitlines():
    if "Compiling entry" in ln:
        entry = ln.split("'")[1] if "'" in ln else ln
    elif "registers" in ln:
        lines.append([entry, ln.strip()])
    elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" \
            not in ln:
        spills.append([entry, ln.strip()])
print("RESULT " + json.dumps({"registers": lines, "spills": spills,
                              "log_tail": log.splitlines()[-1:]}))
"""


def _result(proc, what: str) -> dict:
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{what}: exit {proc.returncode}\n"
                       f"{proc.stderr[-3000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    trees = {"other": args.other.resolve(), "this": ROOT}
    builds = {t: subprocess.Popen([sys.executable, "-c", BUILD], cwd=root,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
              for t, root in trees.items()}
    ok = True
    for t, proc in builds.items():
        out, err = proc.communicate()
        res = _result(subprocess.CompletedProcess(proc.args, proc.returncode,
                                                  out, err), f"build {t}")
        print(json.dumps({"build": t, **res}), flush=True)
        ok &= not res["spills"]
    times = {t: {n: [] for n in ROWS} for t in trees}
    order = [t for _ in range(args.pairs) for t in ("other", "this", "this",
                                                    "other")][:2 * args.pairs]
    for i, t in enumerate(order):
        proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(ROWS)],
                              cwd=trees[t], capture_output=True, text=True)
        res = _result(proc, f"run {t}")
        print(json.dumps({"run": i, "tree": t, **res}), flush=True)
        for n, r in res.items():
            times[t][n].append(r["ms"])
            ok &= r["ok"]
    summary = {}
    for n, (dt, G, D) in ROWS.items():
        nbytes = 2 * G * D * (4 if dt == "float32" else 2) + 4 * G
        s = summary[n] = {"other_ms": statistics.median(times["other"][n]),
                          "this_ms": statistics.median(times["this"][n]),
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        s["this_over_other"] = s["this_ms"] / s["other_ms"]
    print(json.dumps({"summary": summary, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
