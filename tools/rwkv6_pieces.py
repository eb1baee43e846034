#!/usr/bin/env python3
"""How many bf16 pieces the RWKV6 kernel's products need.

    python3 tools/rwkv6_pieces.py [--pieces 1 2 3]

The kernel (``src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu``) splits each
f32 operand of its tensor-core products into ``kPieces`` bf16 pieces (3 in
the source). This builds the source once per piece count into
``build/pieces/``, runs ``chip_smoke.py``'s RWKV6 cases through each in f32
and bf16, and prints one JSON line per case: the final state's distance
from the f64 recurrence, x max(1, max|f64|) (the kernel phase's
``state_err``, gated there at ``RWKV6_STATE_TOL``). Then the device ms of
each build at the served and the timed shapes. Needs one CUDA card and
nvcc.
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

SOURCE = ROOT / "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu"
LINE = "constexpr int kPieces = 3;"
TIMED = [((4, 48, 64, 64), False, 0), ((32, 48, 8, 64), False, 8),
         ((4, 32, 64, 64), False, 0), ((32, 32, 8, 64), False, 8),
         ((4, 512, 64, 64), True, 0), ((4, 2048, 64, 64), True, 0)]


def build(pieces: list) -> dict:
    """One library per piece count, all nvcc started together."""
    src = SOURCE.read_text()
    if LINE not in src:
        raise RuntimeError(f"{SOURCE} no longer has {LINE!r}")
    out = ROOT / "build" / "pieces"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in pieces:
        cu = out / f"rwkv6_p{n}.cu"
        cu.write_text(src.replace(LINE, f"constexpr int kPieces = {n};"))
        procs[n] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"librwkv6_p{n}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc, {n} pieces:\n{log}")
        fn = ctypes.CDLL(str(out / f"librwkv6_p{n}.so")).repro_rwkv6_chunked
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, ll, i, i, ll, p]
        fn.restype = i
        fns[n] = fn
    return fns


def launch(fn, x, out) -> None:
    r, k, v, logw, u, s0 = x
    B, S, H, K = r.shape
    rc = fn(0 if r.dtype == torch.float32 else 1, K, r.data_ptr(),
            k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), None, B, S, H,
            1 if u.dim() == 2 else u.shape[0],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pieces", type=int, nargs="+", default=[2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    fns = build(args.pieces)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)              # chip_smoke.py's kernel-phase draw
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for B, S, H, K, _, strong, state, G in cs.RWKV6_CASES:
            x = cs._rwkv6_inputs(gen, dev, dtype, B, S, H, K, strong=strong,
                                 state=state, G=G)
            s64 = cs._rwkv6_state_f64(x[0], x[1], x[2], x[3], x[5])
            scale = max(1.0, float(s64.abs().max()))
            errs = {}
            for n, fn in fns.items():
                out = (torch.empty_like(x[0]),
                       torch.empty((B, H, K, K), device=dev))
                launch(fn, x, out)
                errs[n] = float((out[1].double() - s64).abs().max()) / scale
                worst[(name, n)] = max(worst.get((name, n), 0.0), errs[n])
            print(json.dumps({"dtype": name, "shape": [B, S, H, K],
                              "strong_decay": strong, "state_in": state,
                              "u_groups": G, "state_err": errs}), flush=True)
    print(json.dumps({"worst_state_err": {f"{d}/{n}": e for (d, n), e
                                          in worst.items()},
                      "limit": cs.RWKV6_STATE_TOL}), flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, state, G in TIMED:
            x = cs._rwkv6_inputs(gen, dev, dtype, *shape, strong=False,
                                 state=state, G=G)
            B, _, H, K = shape
            out = (torch.empty_like(x[0]),
                   torch.empty((B, H, K, K), device=dev))
            ms = {n: cs.time_ms(lambda: launch(fn, x, out))
                  for n, fn in fns.items()}
            print(json.dumps({"dtype": str(dtype).split(".")[-1],
                              "shape": list(shape), "ms": ms}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
