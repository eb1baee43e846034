"""Serving launcher: teacher-forced prompt through decode steps, then greedy
generation, on a virtual PE cube held in one process.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 32 --gen 16 --pes 8 \
        [--cache-dtype int8] [--resident]

The port of ``repro.launch.serve``: ``--pes N`` (default 1) stands in for
the JAX launcher's device count. ``--arch`` takes the ported archs:
qwen3-1.7b, internlm2-20b (48 / 8 heads of 128), phi3-mini-3.8b
(head_dim 96), gemma3-1b (head_dim 256, 5:1 local:global windows),
qwen2-moe-a2.7b, mixtral-8x7b, rwkv6-7b, jamba-1.5-large (Mamba layers
7:1 with attention, MoE on every second layer), llava-next-34b and
whisper-base. whisper-base is an encoder-decoder: its audio frames (the
frontend's stub: precomputed frame embeddings, S_ctx of them, drawn from
``--seed``) and its prompt go through ``Server.prefill_shard``, which runs
the encoder and fills the self and cross caches, and the loop decodes
from there. llava-next-34b's prompt is its patches (the frontend's stub:
``frontend_tokens`` precomputed patch embeddings drawn from ``--seed``) in
front of ``--prompt-len`` text tokens, also through ``prefill_shard``. The
other archs take the prompt through decode steps, as the JAX launcher
does.
``--cache-dtype int8`` serves from the int8 KV cache
(``make_serve_plan(cache_dtype=)``) and ``--resident`` with resident
weights (``Server(resident=)``), the two serving knobs of the reference's
``Server``. It runs on CUDA unless ``--device cpu`` is given, and raises
when no GPU is visible. Prints the decode ms per step, tokens/s and the
launch counts of the flash kernel (its int8 decode form apart), the
reorder and RWKV6 kernels (an MoE model's all_to_alls run on the reorder
kernel; the RWKV6 kernel runs on the forward and prefill paths, so this
loop of decode steps, which takes the one-token recurrence, launches it 0
times).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.kernels.attention import flash
from repro_torch.kernels.reorder import reorder
from repro_torch.kernels.rwkv6 import rwkv6
from repro_torch.models.params import init_params
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          smoke: bool = False, pes: int = 1, device=None, seed: int = 0,
          dtype: torch.dtype = torch.bfloat16, params=None,
          keep_logits: bool = False, n_layers: int | None = None,
          cache_dtype: str = "bf16", resident: bool = False,
          serve_tp: int | None = None, changes: dict | None = None) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and generate
    ``gen`` tokens each. Weights are random from ``seed`` unless ``params``
    (cube tensors on the serve topology) are given. ``n_layers`` cuts the
    model's depth (the widths stay the arch's), and ``changes`` replaces
    any config fields (a cut of width: jamba-1.5-large's d_model / d_ff,
    which one card cannot hold at full width); ``serve_tp`` caps the
    serve cube's tp (the config's ``serve_tp``: the rest of the PEs go to
    data). ``cache_dtype`` and ``resident`` are the plan's and the
    server's knobs.

    Returns the run's record: ``tokens`` (B, prompt_len + gen) -- the
    prompt, then the greedy tokens -- ``step_ms`` per decode step,
    ``ms_per_step`` (median after the first step), ``tok_per_s`` (B tokens
    per step over the whole decode loop), ``flash_launches``,
    ``flash_int8_launches`` (the int8 decode form's), ``reorder_launches``,
    ``rwkv6_launches``, ``prefill`` (whether the prompt went through
    ``prefill_shard``: an encoder-decoder's does, with its ``frames``, and
    a patch frontend's, with its ``patches`` in front of the text, so
    ``tokens`` then holds frontend_tokens + prompt_len + gen positions),
    ``prefill_s``, and with ``keep_logits`` every step's global logits (B,
    V_padded), from the prefill's if there is one."""
    dev = resolve_device(device)
    cfg = configs.get(arch)
    if smoke:
        cfg = cfg.scaled_for_smoke()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if serve_tp is not None:
        cfg = dataclasses.replace(cfg, serve_tp=serve_tp)
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    topo = build_serve_topology(cfg, pes)
    n_patch = cfg.frontend_tokens if cfg.frontend == "patch" else 0
    prompt_len += n_patch           # the patches come first
    S_ctx = prompt_len + gen
    plan = make_serve_plan(cfg, topo, S_ctx=S_ctx, global_batch=batch,
                           cache_dtype=cache_dtype)
    server = Server(cfg, topo, plan, dtype=dtype, resident=resident)
    if params is None:
        params = init_params(cfg, topo, seed, device=dev, resident=resident)
    cache = init_cache(cfg, topo, plan, dtype=dtype, device=dev)
    cube = topo.cube
    ba = plan.batch_axes or None

    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, (batch, prompt_len))
    tokens = torch.zeros((batch, S_ctx), dtype=torch.int64, device=dev)
    tokens[:, n_patch:prompt_len] = torch.from_numpy(
        prompt[:, n_patch:]).to(dev)
    frames = patches = None
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (batch, S_ctx, cfg.frontend_dim)).astype(np.float32))
    if n_patch:
        patches = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (batch, n_patch, cfg.frontend_dim)).astype(np.float32))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    launches0 = (flash.LAUNCHES, flash.INT8_LAUNCHES, reorder.LAUNCHES,
                 rwkv6.LAUNCHES)
    step_ms, all_logits = [], []
    sync()
    t_start = time.perf_counter()
    start, prefill_s = 0, None
    if frames is not None or patches is not None:
        # the encoder (or the patches) and the prompt in one prefill,
        # which fills the caches; decode goes on from the prompt's end
        extra = {k: cube.to_cube(v.to(dev), (ba, None, None))
                 for k, v in (("frames", frames), ("patches", patches))
                 if v is not None}
        logits, cache = server.prefill_shard(params, {
            "tokens": cube.to_cube(tokens[:, :prompt_len], (ba, None)),
            **extra})
        logits = cube.from_cube(logits, (ba, topo.tp))
        tokens[:, prompt_len] = logits.argmax(dim=-1)
        if keep_logits:
            all_logits.append(logits)
        sync()
        prefill_s = time.perf_counter() - t_start
        start = prompt_len
    # otherwise a teacher-forced "prefill" via decode steps (keeps the
    # launcher single-path), then free-running greedy generation
    for t in range(start, S_ctx - 1):
        t0 = time.perf_counter()
        pos = torch.full((batch,), t, dtype=torch.int64, device=dev)
        logits, cache = server.decode_shard(
            params, cache, cube.to_cube(tokens[:, t], (ba,)),
            cube.to_cube(pos, (ba,)))
        logits = cube.from_cube(logits, (ba, topo.tp))
        if t + 1 >= prompt_len:
            tokens[:, t + 1] = logits.argmax(dim=-1)
        if keep_logits:
            all_logits.append(logits)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    return {
        "cfg": cfg, "topo": topo, "plan": plan, "params": params,
        "server": server, "cache": cache, "frames": frames,
        "patches": patches,
        "tokens": tokens.cpu().numpy(),
        "step_ms": step_ms,
        "ms_per_step": float(np.median(step_ms[1:] or step_ms)),
        "tok_per_s": batch * (len(step_ms) + (start > 0)) / wall,
        "flash_launches": flash.LAUNCHES - launches0[0],
        "flash_int8_launches": flash.INT8_LAUNCHES - launches0[1],
        "reorder_launches": reorder.LAUNCHES - launches0[2],
        "rwkv6_launches": rwkv6.LAUNCHES - launches0[3],
        "prefill": start > 0, "prefill_s": prefill_s,
        "logits": all_logits,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--pes", type=int, default=1,
                    help="virtual PEs of the cube (the JAX launcher's "
                         "device count)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dtype", default="bf16", choices=("bf16", "int8"),
                    help="the KV cache: the compute dtype, or int8 codes "
                         "with f32 scales (make_serve_plan's cache_dtype)")
    ap.add_argument("--resident", action="store_true",
                    help="weights replicated over the data axis "
                         "(Server's resident)")
    args = ap.parse_args(argv)

    run = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, smoke=args.smoke, pes=args.pes,
                device=args.device, seed=args.seed,
                cache_dtype=args.cache_dtype, resident=args.resident)
    gen = run["tokens"][:, run["tokens"].shape[1] - args.gen:]
    print(f"arch={run['cfg'].name} cube={run['topo'].cube.describe()} "
          f"cache={run['plan'].S_cache} {run['plan'].cache_dtype}"
          + (f" prefill {run['prefill_s']:.3f} s" if run["prefill"] else ""))
    print(f"generated {gen.shape} tokens; sample row: {gen[0][:12]}")
    print(f"decode {run['ms_per_step']:.3f} ms/step, "
          f"{run['tok_per_s']:.1f} tok/s, "
          f"flash kernel launches={run['flash_launches']} "
          f"(int8 decode form {run['flash_int8_launches']}), "
          f"reorder kernel launches={run['reorder_launches']}, "
          f"rwkv6 kernel launches={run['rwkv6_launches']}")
    return run


if __name__ == "__main__":
    main()
