"""End-to-end training on the port: a ~100M-parameter dense LM for a
few hundred steps with the full stack (hypercube collectives, FSDP specs,
8-bit AdamW, deterministic data stream, checkpointing), attention on the
hand-written flash forward and backward kernels on the card.

    python3 examples_torch/train_100m.py [--steps 200] \\
        [--d-model 512] [--pes 1] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (it raises when no GPU is
visible); on the card ``--d-model / 8`` (the head dim) must be one of the
flash kernel's head dims (16, 32, 64, 96, 128, 256). The counterpart of
``examples/train_100m.py``, whose cube is the host's devices over
``data``: ``--pes N`` (default 1) is the port's data-parallel PE count,
as in ``repro_torch.launch.train``. On the CPU pass a small model, e.g.
``--steps 4 --d-model 64 --layers 2 --seq 32``.
"""
import argparse
import sys
from pathlib import Path

# the repository's src/, for python3 examples_torch/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params, param_specs, trainable)
from repro_torch.models.topology import build_topology  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    Trainer, TrainConfig, init_opt_state, opt_specs, place_batch)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--pes", type=int, default=1,
                    help="data-parallel PEs of the cube (the JAX script's "
                         "device count)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ModelConfig(
        name="pidcomm-100m", family="dense",
        n_layers=args.layers, d_model=args.d_model, n_heads=8, n_kv_heads=4,
        head_dim=args.d_model // 8, d_ff=4 * args.d_model,
        vocab_size=32768, rope_theta=1e4, tp=1,
    )
    print(f"model: {cfg.param_count()/1e6:.1f}M params")

    topo = build_topology(cfg, args.pes, global_batch=args.batch)
    tc = TrainConfig(lr=6e-4, warmup=max(args.steps // 10, 5),
                     total_steps=args.steps)
    specs = param_specs(cfg, topo)
    params = trainable(init_params(cfg, topo, 0, device=dev), specs,
                       topo.cube)
    opt = init_opt_state(params, cfg, topo, tc)

    stream = TokenStream(cfg, DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size))
    ckpt = CheckpointManager(args.ckpt_dir, topo=topo, device=dev, specs={
        "params": specs, "opt": opt_specs(cfg, topo, tc)}) \
        if args.ckpt_dir else None
    trainer = Trainer(cfg, topo, tc, checkpointer=ckpt)

    def batches():
        for s in range(args.steps):
            yield place_batch(stream.global_batch_at(s), cfg, topo, dev)

    params, opt, hist = trainer.run(
        params, opt, batches(),
        checkpoint_every=args.steps // 2 if ckpt else 0,
        log_every=max(args.steps // 25, 1))
    if ckpt:
        ckpt.wait()
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over "
          f"{args.steps} steps")
    return {"params_m": cfg.param_count() / 1e6, "steps": len(hist),
            "losses": [h["loss"] for h in hist],
            "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
            "step_s": list(trainer.step_seconds),
            "saved_steps": ckpt.all_steps() if ckpt else []}


if __name__ == "__main__":
    main()
