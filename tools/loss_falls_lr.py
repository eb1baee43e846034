#!/usr/bin/env python3
"""Whether a repeated-batch loss rise comes from the kernels or the lr.

    python3 tools/loss_falls_lr.py [--arch phi3] [--lrs 3e-4 1e-4] [--steps 8]

Runs ``chip_smoke._mr_loss_falls`` (one batch of 4 x 1,024 tokens repeated
``--steps`` steps at 1 PE, bf16 over f32 masters, the lr warming up over
the run) for the ``TRAIN_MR_ARCHS`` cell ``--arch`` at each lr of
``--lrs``, once with the kernels and once with the plain attention in their
place (``chip_smoke.plain_attention_training``: no flash launch). One JSON
line each: the losses and the seconds. A rise that the plain run shows too
is the optimizer's, not the kernels'. Needs one CUDA card and nvcc.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3",
                    choices=sorted(cs.TRAIN_MR_ARCHS))
    ap.add_argument("--lrs", type=float, nargs="+", default=[3e-4, 1e-4])
    ap.add_argument("--steps", type=int, default=8)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("loss_falls_lr: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.TRAIN_LOSS_STEPS = a.steps
    for lr in a.lrs:
        cs.TRAIN_MR_LOSS_LR = {a.arch: lr}
        for plain in (False, True):
            t0 = time.perf_counter()
            with (cs.plain_attention_training() if plain
                  else contextlib.nullcontext()):
                r = cs._mr_loss_falls(dev, a.arch)
            print(json.dumps({"arch": r["arch"], "lr": lr, "plain": plain,
                              "steps": a.steps, "losses": r["losses"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
