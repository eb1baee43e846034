#!/usr/bin/env python3
"""Design variants of the bf16 flash-attention backward, side by side.

    python3 tools/flash_bwd_variants.py [--rounds 3]

The backward (``src/repro_torch/kernels/attention/csrc/flash_bwd.cu``)
computes in steps of 32 keys (dq pass) and 32 rows (dk / dv pass); its dq
pass holds each warp's Q and dO fragments in registers up to head dim 128
and writes 1 / max(l, 1e-30) for the dk / dv pass; both take p from
ex2.approx; at head dim 256 its ring stages hold 32 keys or rows. This
builds the source as it is and with one of those choices undone (steps of
16 or 64; the dq pass reloading Q and dO by ldmatrix at every k-step, as
it does at head dim 256; the dk / dv pass dividing by l in its loop;
exp2f; 64-row ring stages at head dim 256) into ``build/variants/``,
prints each build's ptxas registers and spills per kernel instance, holds
each against the plain version on ragged shapes (each output within 5e-2
of its own max), and times each at qwen3-1.7b's three training layouts and
gemma3-1b's two (hd 256, window 512; graph-timed, as ``chip_smoke.py``
does) with each pass's device ms from the profiler at qwen3's and gemma3's
1-PE layouts, in ``--rounds`` alternating rounds; the source as it is and
the 64-row-stage build also with 4-warp CTAs in both passes. Steps of 64
do not fit a 32-row stage, so that build skips head dim 256. Then autograd
of SDPA's device time at the same layouts. One JSON line each. Needs one
CUDA card and nvcc.
"""
import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import flash, flash_bwd, ref  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/attention/csrc/flash_bwd.cu"
STEP_Q, STEP_KV = "constexpr int kStepQ = 32;", "constexpr int kStepKV = 32;"
LINV = "      linv[so] = 1.f / fmaxf(l_in[so], 1e-30f);"
LI = "            const float li = ld[row];"
HOLD = "constexpr int kHoldMaxHD = 128;"
STREAM = "static constexpr int STREAM = HD <= 128 ? 64 : 32;"
# B, Sq, Sk, H, KV, q0, hd, window
LAYOUTS = {"1pe": (4, 1024, 1024, 16, 8, 0, 128, -1),
           "tp8": (32, 1024, 1024, 2, 1, 0, 128, -1),
           "data2_tp4": (16, 1024, 1024, 4, 2, 0, 128, -1),
           "gemma3_1pe": (4, 1024, 1024, 4, 1, 0, 256, 512),
           "gemma3_data2_tp4": (16, 1024, 1024, 1, 1, 0, 256, 512)}
PASS_LAYOUTS = ("1pe", "gemma3_1pe")
CHECKS = [(2, 200, 333, 8, 4, 0, 128, -1), (16, 300, 300, 8, 4, 0, 128, -1),
          (2, 192, 229, 8, 2, 37, 128, -1), (2, 300, 300, 4, 1, 0, 256, 64)]


def covers(variant: str, hd: int) -> bool:
    """Steps of 64 rows do not fit the 32-row stages of head dim 256."""
    return not (variant == "steps_64" and hd > 128)


def variants() -> dict:
    src = SOURCE.read_text()
    for needle in (STEP_Q, STEP_KV, HOLD, LINV, LI, STREAM, "ex2(fmaf("):
        if needle not in src:
            raise RuntimeError(f"{SOURCE} no longer has {needle!r}")

    def steps(n):
        return src.replace(STEP_Q, f"constexpr int kStepQ = {n};").replace(
            STEP_KV, f"constexpr int kStepKV = {n};")

    return {"as_is": src, "steps_16": steps(16), "steps_64": steps(64),
            "dq_reloads_q_do": src.replace(HOLD,
                                           "constexpr int kHoldMaxHD = 0;"),
            "dkdv_divides_by_l": src.replace(
                LINV, "      linv[so] = l_in[so];").replace(
                LI, "            const float li = 1.f / fmaxf(ld[row], "
                    "1e-30f);"),
            "exp2f": src.replace("ex2(fmaf(", "exp2f(fmaf("),
            "stream64_hd256": src.replace(
                STREAM, "static constexpr int STREAM = 64;")}


def build(srcs: dict) -> dict:
    """One library per variant, all nvcc started together; prints each
    kernel instance's ptxas registers and spills."""
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = out / f"flash_bwd_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"libflash_bwd_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc, {name}:\n{log}")
        ptxas, entry = {}, None
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                m = re.search(r"(dq|dkdv)_mma_kernelILi(\d+)ELi(\d+)E", ln)
                entry = m and f"{m[1]}_hd{m[2]}_{m[3]}warps"
            elif entry and ("registers" in ln or "spill" in ln):
                ptxas.setdefault(entry, []).append(ln.split(":", 1)[-1]
                                                   .strip())
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        lib = ctypes.CDLL(str(out / f"libflash_bwd_{name}.so"))
        fn = lib.repro_flash_attention_backward
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i] + [p] * 13 + [i] * 8 + [ctypes.c_float]
                       + [i] * 6 + [p])
        fn.restype = i
        lib.repro_flash_bwd_error_string.argtypes = [i]
        lib.repro_flash_bwd_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def four_warps(B, Sq, Sk, H, KV, hd, dtype):
    """``flash_bwd.launch_geometry`` with 4-warp CTAs in both passes."""
    def four(p, own):
        tile = flash_bwd._mma_own(p.name, 4, hd)
        return dataclasses.replace(
            p, grid=(p.grid[0], -(-own // tile)), block=128, own_tile=tile,
            stream_tile=flash_bwd.stream_tile(hd),
            stages=flash_bwd.mma_stages(hd, 4),
            smem=flash_bwd._mma_smem(p.name, 4, hd))
    g = GEOMETRY(B, Sq, Sk, H, KV, hd, dtype)
    return flash_bwd.Geometry(four(g.dq, Sq * (H // KV)), four(g.dkdv, Sk))


GEOMETRY = flash_bwd.launch_geometry
STREAM_TILE = flash_bwd.stream_tile


def inputs(gen, B, Sq, Sk, H, KV, q0, hd, window):
    """The backward's arguments and mask keywords on random bf16 inputs,
    the forward kernel's output and row statistics among them."""
    dev = torch.device("cuda", 0)
    q, k, v = cs._attn_inputs(gen, torch.bfloat16, B, Sq, Sk, H, KV, hd,
                              dev)
    do = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    q_pos = (q0 + torch.arange(Sq, device=dev)).expand(B, -1)
    k_pos = torch.arange(Sk, device=dev).expand(B, -1)
    q_pos, k_pos = (t.to(torch.int32).contiguous() for t in (q_pos, k_pos))
    kw = {"window": window}
    o, m, l = flash.flash_attention(q, k, v, q_pos, k_pos, stats=True, **kw)
    return (q, k, v, o, m, l, do, q_pos, k_pos), kw


def pass_ms(args, kw, iters: int = 10) -> dict:
    """Device ms of each pass of one call, from the profiler."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flash_bwd.flash_attention_backward(*args, **kw)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            for name, pre in cs.FLASH_BWD_PASSES.items():
                if pre in ev.name:
                    out[name] = out.get(name, 0.0) + (
                        ev.time_range.elapsed_us() / 1e3 / iters)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all(["flash"])
    libs = build(variants())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    checks = [inputs(gen, *c) for c in CHECKS]
    layouts = {n: inputs(gen, *s) for n, s in LAYOUTS.items()}
    runs = ([(name, GEOMETRY) for name in libs]
            + [("as_is", four_warps), ("stream64_hd256", four_warps)])
    ok = True
    for rnd in range(a.rounds):
        for name, geometry in (runs if rnd % 2 == 0 else runs[::-1]):
            flash_bwd._lib = lambda lib=libs[name]: lib
            flash_bwd.launch_geometry = geometry
            flash_bwd.stream_tile = (
                (lambda hd: 64) if name == "stream64_hd256" else STREAM_TILE)
            row = {"variant": name, "round": rnd,
                   "warps": "4" if geometry is four_warps else "auto"}
            if rnd == 0:
                errs = []
                for args, kw in checks:
                    if covers(name, args[0].shape[-1]):
                        got = flash_bwd.flash_attention_backward(*args, **kw)
                        want = ref.flash_attention_backward(*args, **kw)
                        errs += cs._rel_to_peak(got, want)[0]
                row["max_err_over_own_max"] = max(errs)
                ok &= max(errs) <= cs.FLASH_BWD_TOL[torch.bfloat16]
            for lname, (args, kw) in layouts.items():
                if covers(name, args[0].shape[-1]):
                    row[f"{lname}_ms"] = cs.time_ms(
                        lambda: flash_bwd.flash_attention_backward(*args,
                                                                   **kw))
            for lname in PASS_LAYOUTS:
                if covers(name, layouts[lname][0][0].shape[-1]):
                    row[f"{lname}_pass_ms"] = pass_ms(*layouts[lname])
            print(json.dumps(row), flush=True)
    flash_bwd.launch_geometry = GEOMETRY
    flash_bwd.stream_tile = STREAM_TILE
    for lname, ((q, k, v, o, m, l, do, qp, kp), kw) in layouts.items():
        ms, form = cs._library_ms(
            cs._device_ms, lambda f: cs._sdpa_backward(q, k, v, do, f), qp,
            kp, True, kw["window"])
        print(json.dumps({"sdpa_backward_device_ms": ms, "layout": lname,
                          "form": form}), flush=True)
    print(cs.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
