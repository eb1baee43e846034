"""Training launcher on a virtual PE cube held in one process.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 20 --batch 4 --seq 1024 --pes 8 \
        [--ckpt-dir ckpts --ckpt-every 10 [--resume]]

The port of ``repro.launch.train``: ``--pes N`` (default 1) stands in for
the JAX launcher's device count, and the model-parallel degree is
``min(cfg.model_parallel, N)`` (1 with ``--smoke``), the rest data
parallelism: tp for a dense or RWKV6 model, ep for an MoE one (etp 1; at
``--pes 8`` qwen2-moe-a2.7b's 64 padded experts go 8 a PE, and every
all_to_all of its dispatch runs on the reorder kernel, forward and
backward). Weights are random from ``--seed``; batches come from the
synthetic ``TokenStream``. It trains on CUDA unless ``--device cpu`` is
given, and raises when no GPU is visible. bf16 compute over f32 master
weights, 8-bit AdamW moments unless ``--fp32-moments``. Prints the loss
every few steps, ms per step, tokens/s and the flash kernels' launch
counts (forward and backward), the reorder kernel's, and the RWKV6
kernels' (forward and backward).

``--ckpt-dir`` binds a ``CheckpointManager`` to the run's topology with
``{"params": param_specs, "opt": opt_specs}``: every ``--ckpt-every``
steps the masters and optimizer state are saved (asynchronously: the next
step does not wait for the disk), and ``--resume`` restores the latest
step and trains on from it. A resume places the saved global arrays on
this run's cube, so ``--pes`` may differ from the run that saved, except
where it shards a weight's last axis another number of ways: the int8
moments' scales hold one column per such shard and cannot move
(``runtime.trainer.resume_state`` raises; the JAX manager's restore raises
where the columns do not divide over the new shards).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.kernels.attention import flash, flash_bwd
from repro_torch.kernels.reorder import reorder
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_bwd
from repro_torch.models.params import init_params, param_specs, trainable
from repro_torch.models.topology import build_topology
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import (
    Trainer, TrainConfig, init_opt_state, opt_specs, place_batch,
    resume_state)


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 256,
          lr: float = 3e-4, warmup: int = 20, smoke: bool = False,
          pes: int = 1, fp32_moments: bool = False, device=None,
          seed: int = 0, ckpt_dir: str = "", ckpt_every: int = 0,
          resume: bool = False) -> dict:
    """Train up to step ``steps``; returns the run's record: ``history``
    (per step float metrics), ``step_ms``, ``tok_per_s``, the final
    ``params`` and ``opt`` state, the flash forward / backward launch
    counts, the reorder's and the RWKV6 forward / backward counts,
    ``start`` (the step resumed from, else 0) and ``ckpt`` (the manager,
    or None)."""
    dev = resolve_device(device)
    cfg = configs.get(arch)
    if smoke:
        cfg = cfg.scaled_for_smoke()
    mp = 1 if smoke else min(cfg.model_parallel, pes)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, ep=mp, etp=1)
    else:
        cfg = dataclasses.replace(cfg, tp=mp)
    topo = build_topology(cfg, pes, global_batch=batch)
    tc = TrainConfig(lr=lr, warmup=warmup, total_steps=steps,
                     adamw=adamw.AdamWConfig(use_8bit=not fp32_moments))
    ckpt = None
    if ckpt_dir:
        ckpt = CheckpointManager(
            ckpt_dir, topo=topo, device=dev,
            specs={"params": param_specs(cfg, topo),
                   "opt": opt_specs(cfg, topo, tc)})
    start = 0
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        params, opt = resume_state(ckpt.restore(start), cfg, topo, tc)
        print(f"resumed from step {start}")
    else:
        params = trainable(init_params(cfg, topo, seed, device=dev),
                           param_specs(cfg, topo), topo.cube)
        opt = init_opt_state(params, cfg, topo, tc)
    stream = TokenStream(cfg, DataConfig(seq_len=seq, global_batch=batch,
                                         vocab_size=cfg.vocab_size,
                                         seed=seed))
    trainer = Trainer(cfg, topo, tc, checkpointer=ckpt)

    def batches():
        for s in range(start, steps):
            yield place_batch(stream.global_batch_at(s), cfg, topo, dev)

    kernels = (flash, flash_bwd, reorder, rwkv6, rwkv6_bwd)
    launches0 = [m.LAUNCHES for m in kernels]
    t0 = time.perf_counter()
    params, opt, history = trainer.run(
        params, opt, batches(), start_step=start,
        checkpoint_every=ckpt_every, log_every=max(steps // 10, 1))
    if ckpt is not None:
        ckpt.wait()
    wall = time.perf_counter() - t0
    step_ms = [t * 1e3 for t in trainer.step_seconds]
    return {"cfg": cfg, "topo": topo, "tc": tc, "params": params, "opt": opt,
            "history": history, "step_ms": step_ms,
            "ms_per_step": (float(np.median(step_ms[1:] or step_ms))
                            if step_ms else float("nan")),
            "tok_per_s": batch * seq * len(history) / wall,
            "start": start, "ckpt": ckpt,
            "slow_steps": trainer.slow_steps,
            **{f"{name}_launches": m.LAUNCHES - n0 for name, m, n0 in zip(
                ("flash", "flash_bwd", "reorder", "rwkv6", "rwkv6_bwd"),
                kernels, launches0)}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--fp32-moments", action="store_true")
    ap.add_argument("--pes", type=int, default=1,
                    help="virtual PEs of the cube (the JAX launcher's "
                         "device count)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    run = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, warmup=args.warmup, smoke=args.smoke,
                pes=args.pes, fp32_moments=args.fp32_moments,
                device=args.device, seed=args.seed, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume)
    cfg, hist = run["cfg"], run["history"]
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"cube={run['topo'].cube.describe()}")
    if not hist:
        print(f"nothing to train: resumed at step {run['start']} of "
              f"{args.steps}")
        return run
    print(f"final loss {hist[-1]['loss']:.4f} (first {hist[0]['loss']:.4f}); "
          f"{run['ms_per_step']:.1f} ms/step, {run['tok_per_s']:.1f} tok/s; "
          f"straggler steps: {run['slow_steps']}; flash kernel launches="
          f"{run['flash_launches']}, backward launches="
          f"{run['flash_bwd_launches']}; reorder kernel launches="
          f"{run['reorder_launches']}; rwkv6 kernel launches="
          f"{run['rwkv6_launches']}, backward launches="
          f"{run['rwkv6_bwd_launches']}")
    return run


if __name__ == "__main__":
    main()
