#!/usr/bin/env python3
"""The flash kernel's decode form of two trees of the repository, in turns
on one card.

    python3 tools/decode_ab.py --other DIR [--pairs 2]

Builds the flash library of this checkout and of ``DIR`` (another checkout,
e.g. the parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), both ``nvcc`` runs started together, and prints each
build's ptxas spill lines for the decode entries. Then times the decode
form on each shape of ``ROWS`` (``chip_smoke.time_ms``: 20 calls in a CUDA
graph replayed 10 times between CUDA events) in a fresh process from each
tree's root, in the order other, this, this, other, ... for ``--pairs``
pairs, and checks every launch against the plain version
(``chip_smoke.KERNEL_TOL``). Prints one JSON line per run and a summary:
each tree's median ms per shape and the change's ratio to the other's.
Needs one CUDA card and nvcc; about a minute for the builds and 15 s a
run.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (q dtype, B, H, KV, hd, Sk, causal, window, partial, int8 cache)
ROWS = {
    "qwen3_decode_1pe": ("bfloat16", 4, 16, 8, 128, 48, True, -1, False,
                         False),
    "qwen3_decode_8pe": ("bfloat16", 32, 16, 8, 128, 6, True, -1, True,
                         False),
    "long_decode_4096": ("bfloat16", 4, 16, 8, 128, 4096, True, -1, False,
                         False),
    "qwen3_decode_1pe_f32": ("float32", 4, 16, 8, 128, 48, True, -1, False,
                             False),
    "internlm2_decode_g6": ("bfloat16", 4, 48, 8, 128, 48, True, -1, False,
                            False),
    "phi3_decode_hd96": ("bfloat16", 4, 32, 32, 96, 48, True, -1, False,
                         False),
    "gemma3_decode_hd256": ("bfloat16", 4, 4, 1, 256, 48, True, 512, False,
                            False),
    "whisper_cross_hd64": ("bfloat16", 4, 8, 8, 64, 48, False, -1, False,
                           False),
    "int8_qwen3_decode_1pe": ("bfloat16", 4, 16, 8, 128, 48, True, -1, True,
                              True),
}

RUN = r"""
import json, sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
from repro_torch.kernels.attention import flash, ref
from repro_torch.models.blocks import quantize_kv
rows = json.loads(sys.argv[1])
dev = torch.device("cuda")
out = {}
for name, (dt, B, H, KV, hd, Sk, causal, window, partial, int8) in \
        rows.items():
    dtype = getattr(torch, dt)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, Sk, KV, hd), generator=gen, device=dev)
            for _ in range(2))
    kw = {"causal": causal, "window": window, "partial": partial}
    if int8:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), \
            quantize_kv(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    q_pos = torch.full((B, 1), Sk - 1, dtype=torch.int32, device=dev)
    k_pos = torch.arange(Sk, dtype=torch.int32, device=dev).expand(
        B, Sk).contiguous()
    got = flash.flash_attention(q, k, v, q_pos, k_pos, **kw)
    want = ref.flash_attention(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    err = cs._compare(got, want, partial)
    out[name] = {"ms": cs.time_ms(lambda: flash.flash_attention(
                     q, k, v, q_pos, k_pos, **kw)),
                 "err": err, "ok": err <= cs.KERNEL_TOL[dtype]}
print("RESULT " + json.dumps(out))
"""

BUILD = r"""
import json, sys
sys.path[:0] = [".", "src"]
from repro_torch.kernels import _build
log = _build.build_all(["flash"])["flash"]
entry, spills = None, []
for ln in log.splitlines():
    if "Compiling entry" in ln:
        entry = ln.split("'")[1] if "'" in ln else ln
    elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" \
            not in ln:
        spills.append([entry, ln.strip()])
print("RESULT " + json.dumps({"spills": spills, "log_tail":
                              log.splitlines()[-1:]}))
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
    summary = {n: {"other_ms": statistics.median(times["other"][n]),
                   "this_ms": statistics.median(times["this"][n])}
               for n in ROWS}
    for s in summary.values():
        s["this_over_other"] = s["this_ms"] / s["other_ms"]
    print(json.dumps({"summary": summary, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
