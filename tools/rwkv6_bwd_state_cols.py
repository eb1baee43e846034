#!/usr/bin/env python3
"""How many value columns a warp of the RWKV6 backward's pass 1 should own.

    python3 tools/rwkv6_bwd_state_cols.py [--cols 16 32 64]

Pass 1 of the backward (``rwkv6_bwd_state_kernel`` in
``src/repro_torch/kernels/rwkv6/csrc/rwkv6_bwd.cu``) carries the state's
gradient alone; its columns are independent, so a warp owns 16 key
channels by ``kStateCols`` value columns of one (batch, head). This builds
the source once per column count into ``build/state_cols/``, runs the
backward through each build at the training shapes in bf16 (1 PE and tp 8
of rwkv6-7b), and prints one JSON line per build and shape: whether its
outputs equal the source's bit for bit (the split changes which warp takes
a column, not its arithmetic), the call's ms (``chip_smoke.time_ms``) and
each kernel's device ms (``chip_smoke._rwkv6_bwd_pass_ms``). Needs one
CUDA card and nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_bwd  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/rwkv6/csrc/rwkv6_bwd.cu"
LINE = "constexpr int kStateCols = 64;"
SHAPES = [(4, 1024, 64, 64, 0), (32, 1024, 8, 64, 8)]


def build(cols: list) -> dict:
    """One library per column count, all nvcc started together."""
    src = SOURCE.read_text()
    if LINE not in src:
        raise RuntimeError(f"{SOURCE} no longer has {LINE!r}")
    out = ROOT / "build" / "state_cols"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in cols:
        cu = out / f"rwkv6_bwd_c{n}.cu"
        cu.write_text(src.replace(LINE, f"constexpr int kStateCols = {n};"))
        procs[n] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"librwkv6_bwd_c{n}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc, {n} columns:\n{log}")
        libs[n] = ctypes.CDLL(str(out / f"librwkv6_bwd_c{n}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cols", type=int, nargs="+", default=[16, 32, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    libs = build(args.cols)
    source_lib = rwkv6_bwd._lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for B, S, H, K, G in SHAPES:
        r, k, v, logw, u, s0 = cs._rwkv6_inputs(
            gen, dev, torch.bfloat16, B, S, H, K, strong=False, state=False,
            G=G)
        do = torch.randn(B, S, H, K, generator=gen,
                         device=dev).to(torch.bfloat16)
        _, _, states = rwkv6.rwkv6_chunked(r, k, v, logw, u, s0,
                                           states=True)
        a = (r, k, v, logw, u, s0, do, None, states)
        want = rwkv6_bwd.rwkv6_chunked_backward(*a)
        for n, lib in libs.items():
            rwkv6_bwd._lib = lambda lib=lib: _typed(lib)
            try:
                got = rwkv6_bwd.rwkv6_chunked_backward(*a)
                same = all(torch.equal(x, y) for x, y in zip(got, want)
                           if y is not None)
                row = {"cols": n, "shape": [B, S, H, K],
                       "same_bits_as_source": same,
                       "ms": cs.time_ms(
                           lambda: rwkv6_bwd.rwkv6_chunked_backward(*a)),
                       "pass_ms": cs._rwkv6_bwd_pass_ms(a)}
            finally:
                rwkv6_bwd._lib = source_lib
            print(json.dumps(row), flush=True)
    return 0


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.repro_rwkv6_backward
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i] + [p] * 16 + [ll, i, i, ll, p]
        fn.restype = i
        lib.repro_rwkv6_backward_error_string.argtypes = [i]
        lib.repro_rwkv6_backward_error_string.restype = ctypes.c_char_p
    return lib


if __name__ == "__main__":
    sys.exit(main())
