"""Perf-iteration harness: one (arch x shape) cell of the dry run under a
named optimization variant.

The counterpart of ``repro.launch.perf``. It traces the cell's two-point
cost probe (``dryrun.run_probe``) under the variant's config transform and
knobs, derives the roofline terms for an NVIDIA H100 80GB HBM3 at 700 W
(``terms``) and writes ``results/perf/<arch>_<shape>__<variant>.json``:

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-1.7b \
        --shape train_4k --variant lowp2 [--multipod] [--profile P.json]

The terms are per PE and ideal: operations over the card's bf16 tensor
peak, eager bytes (``dryrun``'s ``bytes accessed``, no fusion) over its
memory rate, and the collectives at the planner's seconds for the
recorded schedule, which exist only under an installed measured profile
(``--profile``: the tuner's fit on the card); without one the term is
null, since the port's planner holds no time constant.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as dc
import json
import os

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_name, production_cube

VARIANTS = {
    # name -> (cfg transform, dryrun knobs)
    "baseline": (None, {}),
    "sort_dispatch": (lambda c: dc.replace(c, moe_dispatch="sort"), {}),
    "resident_weights": (None, {"resident": True}),
    "int8_kv": (None, {"cache_dtype": "int8"}),
    "resident+int8_kv": (None, {"resident": True, "cache_dtype": "int8"}),
    "cap1.0": (lambda c: dc.replace(c, capacity_factor=1.0), {}),
    "sort+cap1.0": (lambda c: dc.replace(c, capacity_factor=1.0,
                                         moe_dispatch="sort"), {}),
    "lowp": (None, {"lowp": 1}),
    "lowp2": (None, {"lowp": 2}),
    "lowp2+sort": (lambda c: dc.replace(c, moe_dispatch="sort"),
                   {"lowp": 2}),
    "serve_bf16": (None, {"resident": True, "serve_bf16": True}),
    "serve_bf16+int8_kv": (None, {"resident": True, "serve_bf16": True,
                                  "cache_dtype": "int8"}),
}

# the card the terms are for, as nvidia-smi names it, and its rates: the
# dense bf16 tensor peak (NVIDIA's H100 SXM data sheet; PERF.md's mfu) and
# the HBM3 rate (PERF.md's bytes bound)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# global tokens a step of each shape processes, and the model FLOPs per
# active parameter and token (6 for a train step, 2 for inference)
SHAPE_TOKENS = {"train_4k": 256 * 4096, "prefill_32k": 32 * 32768,
                "decode_32k": 128, "long_500k": 1}
TRAIN_MULT = {"train_4k": 6, "prefill_32k": 2, "decode_32k": 2,
              "long_500k": 2}


def terms(rec: dict) -> dict:
    """The roofline terms of a dry-run record (the probe's ``cost_x`` where
    it has one), per PE, on ``CARD``: ``compute_s``, ``memory_s``,
    ``collective_s`` (null without a measured profile), ``dominant`` (the
    largest term there is), ``model_flops`` (the per-PE model FLOPs, mult
    x active parameters x tokens / PEs), ``useful_ratio`` (model FLOPs
    over traced FLOPs) and ``roofline_frac`` (model FLOPs at the peak over
    the largest term)."""
    cost = rec.get("cost_x") or rec["cost"]
    flops = cost.get("flops", 0.0)
    t_c = flops / BF16_PEAK_FLOPS
    t_m = cost.get("bytes accessed", 0.0) / HBM_BYTES_PER_S
    t_x = rec.get("comm_seconds_x", rec.get("comm_seconds"))
    present = [("compute", t_c), ("memory", t_m)]
    if t_x is not None:
        present.append(("collective", t_x))
    dom, step = max(present, key=lambda kv: kv[1])
    pes = production_cube(rec["mesh"] == mesh_name(True))[0]
    model_flops = (TRAIN_MULT[rec["shape"]] * rec["params_active"]
                   * SHAPE_TOKENS[rec["shape"]] / pes)
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom, "model_flops": model_flops,
            "useful_ratio": model_flops / flops if flops else 0.0,
            "roofline_frac": (model_flops / BF16_PEAK_FLOPS / step
                              if step else 0.0),
            "card": CARD}


def run(arch: str, shape: str, variant: str, *, multi_pod: bool = False,
        out: str = "results/perf") -> dict:
    """Probe one cell under ``variant``, write its record, return it."""
    tfm, kw = VARIANTS[variant]
    cfg = configs.get(arch)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(multi_pod),
           "variant": variant, "status": "ok",
           "params_total": cfg.param_count(),
           "params_active": cfg.active_param_count()}
    rec.update(dryrun.run_probe(arch, shape, multi_pod=multi_pod,
                                cfg_transform=tfm, **kw))
    rec["cost"] = rec["cost_x"]
    t = terms(rec)
    rec["terms"] = {k: t[k] for k in ("compute_s", "memory_s", "collective_s",
                                      "dominant", "useful_ratio",
                                      "roofline_frac", "card")}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{arch}_{shape}__{variant}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    x = t["collective_s"]
    print(f"{arch}/{shape}/{variant}: compute={t['compute_s']:.3e}s "
          f"memory={t['memory_s']:.3e}s collective="
          f"{'null' if x is None else f'{x:.3e}s'} "
          f"dominant={t['dominant']} frac={t['roofline_frac']:.2%}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(dryrun.SHAPES))
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--profile", default=None, metavar="PROFILE_JSON",
                    help="a tuned CommProfile: prices the collective term")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args(argv)
    ctx = contextlib.nullcontext()
    if args.profile:
        from repro_torch.core.planner import install_profile
        from repro_torch.tuning import CommProfile
        ctx = install_profile(CommProfile.load(args.profile))
    with ctx:
        return run(args.arch, args.shape, args.variant,
                   multi_pod=args.multipod, out=args.out)


if __name__ == "__main__":
    main()
