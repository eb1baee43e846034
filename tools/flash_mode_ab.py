#!/usr/bin/env python3
"""The flash forward and backward kernels of two trees of the repository:
the launches whose bits must not move, and mode 2's time, on one card.

    python3 tools/flash_mode_ab.py --other DIR [--pairs 2]

Builds the flash and flash_bwd libraries of this checkout and of ``DIR``
(another checkout, e.g. the parent commit unpacked with ``git archive``
into a directory that ``.gitignore`` lists), all ``nvcc`` runs started
together, and prints each build's ptxas spill lines. Then, in a fresh
process from each tree's root, on inputs drawn from one seed a case:

* bits: every row of this tree's ``chip_smoke.FLASH_CASES`` through
  ``flash.flash_attention`` in f32 and in bf16 modes 0 and 1 (as the row
  asks, partial or full; a full row again with the row statistics), and
  every row of ``chip_smoke.FLASH_BWD_CASES`` through the full backward
  (``flash_bwd.flash_attention_backward``, fed the plain forward's output
  and statistics) in f32 and bf16. Each output's sha1 is printed; the two
  trees' must be equal.
* time: the bf16 forms in modes 0, 1 and 2 at ``TIMED`` (training
  forwards with statistics at head dims 16-256, qwen3's 2,048- and
  3,008-token prefills, 512- and 4,096-key decodes),
  ``chip_smoke.time_ms`` (20 calls in a CUDA graph replayed 10 times
  between CUDA events), in the order other, this, this, other, ... for
  ``--pairs`` pairs.

Prints one JSON line per run and a summary: the cases whose digests
differ, and each tree's median ms per row and mode with the ratio. Needs
one CUDA card and nvcc; about 5 minutes for 2 pairs.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# name: (B, Sq, Sk, H, KV, hd, partial, stats) at causal, bf16; the
# training forwards take the heads of a model of that head dim (qwen3 128,
# phi3 96, whisper 64, gemma3 256; 32 and 16 qwen3's)
TIMED = {"train_forward": (4, 1024, 1024, 16, 8, 128, False, True),
         "train_forward_hd96": (4, 1024, 1024, 32, 32, 96, False, True),
         "train_forward_hd64": (4, 1024, 1024, 8, 8, 64, False, True),
         "train_forward_hd256": (4, 1024, 1024, 4, 1, 256, False, True),
         "train_forward_hd32": (4, 1024, 1024, 16, 8, 32, False, True),
         "train_forward_hd16": (4, 1024, 1024, 16, 8, 16, False, True),
         "prefill_2048": (4, 2048, 2048, 16, 8, 128, False, False),
         "prefill_3008": (4, 3008, 3008, 16, 8, 128, False, False),
         "decode_512": (4, 1, 512, 16, 8, 128, True, False),
         "decode_4096": (4, 1, 4096, 16, 8, 128, True, False)}

BITS = r"""
import hashlib, json, sys
sys.path[:0] = [".", "src"]
import torch
from repro_torch.kernels.attention import flash, flash_bwd, ref
fwd_cases, bwd_cases = json.loads(sys.argv[1])
dev = torch.device("cuda")
out = {}

def digest(ts):
    return [hashlib.sha1(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes()).hexdigest() for t in ts]

def positions(B, Sq, Sk, q0, k0, shards):
    if shards:
        q_pos = torch.full((B, 1), q0, device=dev)
        k_pos = (torch.arange(B, device=dev)[:, None] * Sk
                 + torch.arange(Sk, device=dev))
    else:
        q_pos = (q0 + torch.arange(Sq, device=dev)).expand(B, -1)
        k_pos = (k0 + torch.arange(Sk, device=dev)).expand(B, -1)
    return [p.to(torch.int32).contiguous() for p in (q_pos, k_pos)]

def inputs(seed, dtype, B, Sq, Sk, H, KV, hd):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
                      (B, Sq, H, hd))]

for i, (B, Sq, Sk, H, KV, hd, causal, window, q0, k0, partial,
        shards) in enumerate(fwd_cases):
    pos = positions(B, Sq, Sk, q0, k0, shards)
    for dt, modes in (("float32", (0,)), ("bfloat16", (0, 1))):
        q, k, v, _ = inputs(i, getattr(torch, dt), B, Sq, Sk, H, KV, hd)
        for mode in modes:
            kw = dict(causal=causal, window=window, lowp=mode)
            got = flash.flash_attention(q, k, v, *pos, partial=partial, **kw)
            out[f"fwd{i}/{dt}/mode{mode}"] = digest(
                got if partial else [got])
            if not partial:
                out[f"fwd{i}/{dt}/mode{mode}/stats"] = digest(
                    flash.flash_attention(q, k, v, *pos, stats=True, **kw))
for i, (B, Sq, Sk, H, KV, causal, window, q0, k0, hd) in enumerate(
        bwd_cases):
    pos = positions(B, Sq, Sk, q0, k0, False)
    kw = dict(causal=causal, window=window)
    for dt in ("float32", "bfloat16"):
        q, k, v, do = inputs(1000 + i, getattr(torch, dt), B, Sq, Sk, H,
                             KV, hd)
        o, m, l = ref.flash_attention(q, k, v, *pos, stats=True, **kw)
        o = o.contiguous()   # f32: the plain output is a transposed view
        out[f"bwd{i}/{dt}"] = digest(flash_bwd.flash_attention_backward(
            q, k, v, o, m, l, do, *pos, **kw))
torch.cuda.synchronize()
print("RESULT " + json.dumps(out))
"""

TIME = r"""
import json, sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
from repro_torch.kernels.attention import flash
rows = json.loads(sys.argv[1])
dev = torch.device("cuda")
out = {}
for name, (B, Sq, Sk, H, KV, hd, partial, stats) in rows.items():
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=dev).bfloat16()
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    q_pos = (Sk - Sq + torch.arange(Sq, device=dev, dtype=torch.int32)
             ).expand(B, -1).contiguous()
    k_pos = torch.arange(Sk, device=dev, dtype=torch.int32).expand(
        B, -1).contiguous()
    for mode in (0, 1, 2):
        kw = dict(causal=True, partial=partial, stats=stats, lowp=mode)
        out[f"{name}/mode{mode}"] = cs.time_ms(
            lambda: flash.flash_attention(q, k, v, q_pos, k_pos, **kw))
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""

BUILD = r"""
import json, sys
sys.path[:0] = [".", "src"]
from repro_torch.kernels import _build
logs = _build.build_all(["flash", "flash_bwd"])
spills = []
for name, log in logs.items():
    entry = None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" \
                not in ln:
            spills.append([name, entry, ln.strip()])
# the forward's mma instances: registers (ptxas's "Used N registers")
regs = {}
entry = None
for ln in logs["flash"].splitlines():
    if "Compiling entry" in ln:
        entry = ln.split("'")[1] if "'" in ln else ln
    elif "Used" in ln and entry and "fwd_mma" in entry:
        regs[entry.split("flash_fwd_mma_kernel")[1][:12]] = \
            ln.split("Used")[1].split(",")[0].strip()
print("RESULT " + json.dumps({"spills": spills, "mma_registers": regs,
                              "nvcc": {n: log.splitlines()[-1:]
                                       for n, log in logs.items()}}))
"""


def _result(proc, what: str) -> dict:
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{what}: exit {proc.returncode}\n"
                       f"{proc.stderr[-3000:]}")


def _run(code: str, arg: str, root: Path, what: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", code, arg], cwd=root,
                          capture_output=True, text=True)
    return _result(proc, what)


def main() -> int:
    import chip_smoke as cs
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
    cases = json.dumps([cs.FLASH_CASES, cs.FLASH_BWD_CASES])
    bits = {t: _run(BITS, cases, root, f"bits {t}")
            for t, root in trees.items()}
    differ = sorted(n for n in bits["this"]
                    if bits["this"][n] != bits["other"].get(n))
    print(json.dumps({"bits": {"launches": len(bits["this"]),
                               "differ": differ}}), flush=True)
    ok &= not differ and len(bits["this"]) == len(bits["other"])
    times = {t: {} for t in trees}
    order = [t for _ in range(args.pairs)
             for t in ("other", "this", "this", "other")][:2 * args.pairs]
    for i, t in enumerate(order):
        res = _run(TIME, json.dumps(TIMED), trees[t], f"time {t}")
        print(json.dumps({"run": i, "tree": t, **res}), flush=True)
        for n, ms in res.items():
            times[t].setdefault(n, []).append(ms)
    summary = {n: {"other_ms": statistics.median(times["other"][n]),
                   "this_ms": statistics.median(times["this"][n])}
               for n in times["this"]}
    for s in summary.values():
        s["this_over_other"] = s["this_ms"] / s["other_ms"]
    print(json.dumps({"summary": summary, "bits_differ": differ, "ok": ok}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
