"""Flash-decode serving over the in-process PE cube.

The counterpart of ``repro.models.serving``. Decode runs on the serve
topology (maximal model sharding, see ``build_serve_topology``):
activations are replicated over the model axes, the KV cache is
sequence-sharded over them, and every layer's partial attention (the flash
kernel's ``(acc, m, l)``) is LSE-combined with one max and two additive
all-reduces over the cache axes.

Ported: the compute-dtype and the int8 (``cache_dtype="int8"``: int8
codes with an f32 scale a (slot, kv head), the paper's §V-C 8-bit
layout) attention caches and ``decode_shard`` for attention layers with
dense or MoE FFNs; the encoder-decoder's cross cache (the encoder's K/V
of S_ctx positions, compute dtype) and cross step; the Mamba cache (the
f32 SSM state and the compute-dtype conv tail, both sharded over tp by
channel) and the RWKV6 cache (f32 state sharded over tp, compute-dtype
token shifts) and their decode; and ``prefill_shard`` for all of them
(the patch frontend's patches in the prompt's first positions), whose
cache drops straight into
``decode_shard``: the JAX package's prefill leaves each PE its sequence
slice of its own KV heads, which the decode layout cannot be rebuilt from,
so the port reshards the prompt's K/V into the decode layout inside the
attention block (``blocks._decode_cache_kv``: one all_to_all over tp).
Resident weights: ``Server(..., resident=True)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import blocks
from repro_torch.models.config import (
    ModelConfig, ATTN, FULL_WINDOW, MAMBA, MOE, RWKV, RWKVCM)
from repro_torch.models.layers import rms_norm, cube_matmul
from repro_torch.models.lm import Model
from repro_torch.models.topology import Topology


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Static decode-cell geometry."""
    S_ctx: int                  # context length (max position + 1)
    S_cache: int                # allocated cache length (< S_ctx if rolling)
    global_batch: int
    batch_axes: tuple[str, ...]  # axes sharding the batch (() = replicated)
    kv_axes: tuple[str, ...]     # axes sharding the cache sequence
    cache_dtype: str = "bf16"    # "bf16" (the compute dtype) | "int8"


def make_serve_plan(cfg: ModelConfig, topo: Topology, *, S_ctx: int,
                    global_batch: int, cache_dtype: str = "bf16"
                    ) -> ServePlan:
    """The decode geometry. ``cache_dtype`` "bf16" stores the attention
    cache in the compute dtype, "int8" as int8 codes with f32 scales."""
    if cache_dtype not in ("bf16", "int8"):
        raise ValueError(
            f"cache_dtype must be 'bf16' or 'int8', got {cache_dtype!r} "
            "(the KV cache is either compute-dtype or the §V-C 8-bit "
            "cross-domain-modulated layout; nothing else has a decode path)")
    pods = topo.size(("pod",)) if "pod" in topo.cube.dim_names else 1
    batch_axes: tuple[str, ...] = ()
    b = global_batch
    if pods > 1 and b % pods == 0 and b >= pods:
        batch_axes += ("pod",)
        b //= pods
    dsz = topo.cube.size("data") if "data" in topo.cube.dim_names else 1
    if dsz > 1 and b % dsz == 0 and b >= dsz:
        batch_axes += ("data",)
        b //= dsz
    # uniform static sliding window => rolling cache bounded by the window
    wins = cfg.windows()
    S_cache = S_ctx
    if (wins >= 0).all() and len(set(wins.tolist())) == 1:
        S_cache = min(S_ctx, int(wins[0]))
    kv_axes = topo.tp
    n = topo.size(kv_axes)
    S_cache = int(math.ceil(S_cache / n) * n)   # shard evenly
    return ServePlan(S_ctx=S_ctx, S_cache=S_cache, global_batch=global_batch,
                     batch_axes=batch_axes, kv_axes=kv_axes,
                     cache_dtype=cache_dtype)


# ------------------------------------------------------------- cache layout
def cache_defs(cfg: ModelConfig, topo: Topology, plan: ServePlan,
               dtype: torch.dtype = torch.bfloat16):
    """(global shape, spec, dtype) tree for the decode cache; the
    compute-dtype cache is stored in ``dtype``, the Mamba and RWKV states
    in f32 whatever ``dtype`` is. An int8 plan stores K / V as int8 with f32
    scales ``k_s`` / ``v_s`` (n_units, B, S_cache, KV); an encoder-decoder
    model adds the cross cache ``xk`` / ``xv`` (n_units, B, S_ctx, KV, hd)
    in ``dtype``, S_ctx sequence-sharded over the kv axes."""
    unit = cfg.unit()
    n_units = cfg.n_layers // unit
    B = plan.global_batch
    ba = plan.batch_axes or None
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    n = topo.size(plan.kv_axes)
    if cfg.is_encoder_decoder and plan.S_ctx % n:
        raise ValueError(
            f"{cfg.name}: the cross cache's S_ctx {plan.S_ctx} encoder "
            f"positions do not split over the {n} kv shards")
    din = cfg.mamba_expand * cfg.d_model
    tree = {}
    for p, (mixer, ffn) in enumerate(zip(cfg.mixers()[:unit],
                                         cfg.ffns()[:unit])):
        d = {}
        if mixer == ATTN:
            shp = (n_units, B, plan.S_cache, KV, hd)
            spec = (None, ba, plan.kv_axes, None, None)
            int8 = plan.cache_dtype == "int8"
            d["k"] = d["v"] = (shp, spec, torch.int8 if int8 else dtype)
            if int8:
                d["k_s"] = d["v_s"] = ((n_units, B, plan.S_cache, KV),
                                       (None, ba, plan.kv_axes, None),
                                       torch.float32)
            if cfg.is_encoder_decoder:
                d["xk"] = d["xv"] = ((n_units, B, plan.S_ctx, KV, hd), spec,
                                     dtype)
        elif mixer == MAMBA:
            d["ssm"] = ((n_units, B, din, cfg.d_state),
                        (None, ba, topo.tp, None), torch.float32)
            d["conv"] = ((n_units, B, cfg.conv_kernel - 1, din),
                         (None, ba, None, topo.tp), dtype)
        else:
            rhd = cfg.rwkv_head_dim
            d["state"] = ((n_units, B, cfg.d_model // rhd, rhd, rhd),
                          (None, ba, topo.tp, None, None), torch.float32)
            d["shift"] = ((n_units, B, cfg.d_model), (None, ba, None), dtype)
        if ffn == RWKVCM:
            d["cm_shift"] = ((n_units, B, cfg.d_model), (None, ba, None),
                             dtype)
        tree[f"p{p}"] = d
    return tree


def init_cache(cfg, topo, plan, *, dtype: torch.dtype = torch.bfloat16,
               device) -> dict:
    """Zero cache as cube tensors ``(*cube, n_units, B_l, S_loc, KV, hd)``,
    every PE's chunk materialized (decode writes it in place)."""
    cube = topo.cube
    return {p: {k: torch.zeros(cube.dim_sizes + cube.local_shape(shp, spec),
                               dtype=dt, device=device)
                for k, (shp, spec, dt) in d.items()}
            for p, d in cache_defs(cfg, topo, plan, dtype).items()}


# ------------------------------------------------------------------ decode
class Server:
    def __init__(self, cfg: ModelConfig, topo: Topology, plan: ServePlan, *,
                 dtype: torch.dtype = torch.bfloat16,
                 resident: bool = False):
        """``resident``: weights replicated over the data axis (place them
        with ``init_params(..., resident=True)``); decode then gathers no
        weight over ``data``."""
        self.cfg, self.topo, self.plan = cfg, topo, plan
        self.dtype = dtype
        self.model = Model(cfg, topo, dtype=dtype, resident=resident)

    def decode_shard(self, params, cache, tokens, pos):
        """One decode step. tokens, pos: (*cube, B_l) int. Writes the new
        token's K/V (attention) or the new state and token shifts (RWKV)
        into ``cache`` in place and returns (logits (*cube, B_l, V_local)
        f32, cache)."""
        cfg, topo, plan = self.cfg, self.topo, self.plan
        m = self.model
        cn = topo.cube.ndim
        emb_l = m._gather_embed(params)
        x = topo.comm(topo.tp).all_reduce(
            m._embed_tokens(emb_l, tokens[..., None]))[..., 0, :]
        rolling = plan.S_cache < plan.S_ctx
        for u in range(m.n_units):
            for p in range(m.unit):
                key = f"p{p}"
                w = blocks.gather_params(m.unit_params(params, u, p),
                                         m.unit_specs[key], topo, self.dtype)
                # views of unit u's cache leaves: written with copy_
                c = {k: v.select(cn, u) for k, v in cache[key].items()}
                if m.mixers[p] == RWKV:
                    x, state, shift = blocks.rwkv_mix_decode(
                        cfg, topo, w, x, c["state"], c["shift"])
                    c["state"].copy_(state)
                    c["shift"].copy_(shift)
                elif m.mixers[p] == MAMBA:
                    x, state, tail = blocks.mamba_mix_decode(
                        cfg, topo, w, x, c["ssm"], c["conv"])
                    c["ssm"].copy_(state)
                    c["conv"].copy_(tail)
                else:
                    x = blocks.attn_decode(
                        cfg, topo, w, x, c, pos, window=int(m.windows[u, p]),
                        kv_axes=plan.kv_axes, rolling=rolling,
                        dtype=self.dtype)
                    if cfg.is_encoder_decoder:
                        x = blocks.attn_decode(
                            cfg, topo, w, x, c, pos, window=FULL_WINDOW,
                            kv_axes=plan.kv_axes, rolling=False,
                            dtype=self.dtype, prefix="x", cross=True,
                            keys=("xk", "xv"))
                if m.ffns[p] == MOE:
                    x = blocks.moe_ffn_decode(cfg, topo, w, x)
                elif m.ffns[p] == RWKVCM:
                    x, shift = blocks.rwkv_channel_mix_decode(
                        cfg, topo, w, x, c["cm_shift"])
                    c["cm_shift"].copy_(shift)
                else:
                    x = blocks.dense_ffn_decode(cfg, topo, w, x)
        hn = rms_norm(x, m.final_norm(params), cfg.norm_eps)
        logits = cube_matmul(hn, m._head(params), cn).float()
        return logits, cache

    # ------------------------------------------------------------- prefill
    def prefill_shard(self, params, batch):
        """Forward over the whole prompt, batch["tokens"] (*cube, B_l, S)
        laid out over the plan's batch axes. Returns (the last position's
        logits (*cube, B_l, V_local) f32, the decode cache of the prompt:
        ``init_cache``'s layout and dtypes, so ``decode_shard`` takes it as
        it is, at positions from S on).

        The JAX package runs prefill on a training-style topology; here the
        serve topology is that cube (tp = PEs, no cp). An attention layer's
        cache holds the prompt's K/V after RoPE and k_norm, slot s the key
        of position s (a rolling cache: the last S_cache positions, each at
        slot position % S_cache, the slot decode's rolling rule reads).
        A prompt that does not split over the sequence-parallel PEs is
        padded at its end with token 0: the causal mask keeps the pad out
        of every prompt position, the cache leaves it out, and an MoE layer
        routes it like any token (an RWKV6 or Mamba prompt must split:
        its state would take the pad in). RWKV6 layers keep the
        recurrence's final state (one kernel launch per layer) and the
        token shifts, Mamba layers the scan's final state and the conv's
        tail. The patch frontend's batch["patches"] (*cube, B_l, F,
        frontend_dim) fill the prompt's first F positions
        (``Model.embed_input``). An
        encoder-decoder model encodes batch["frames"] (*cube, B_l, S_ctx,
        frontend_dim) first, and each decoder layer's cross-attention
        leaves the encoder's K/V of all S_ctx positions in the cross cache
        ``xk`` / ``xv``.

        Like the reference's prefill, this one computes the K/V in the
        compute dtype; an int8 plan's cache is filled by decode steps
        alone, so prefill raises on one."""
        cfg, topo, plan = self.cfg, self.topo, self.plan
        m = self.model
        cn = topo.cube.ndim
        tokens = batch["tokens"]
        S = tokens.shape[cn + 1]
        rolling = plan.S_cache < plan.S_ctx
        if plan.cache_dtype != "bf16" and ATTN in m.mixers:
            raise ValueError(
                f"{cfg.name}: prefill computes the K/V in the compute dtype "
                f"({self.dtype}), which does not install into a "
                f"{plan.cache_dtype} cache; fill an int8 cache by decode "
                "steps")
        enc_out = None
        if cfg.is_encoder_decoder:
            S_enc = batch["frames"].shape[cn + 1]
            if S_enc != plan.S_ctx:
                raise ValueError(
                    f"{cfg.name}: {S_enc} encoder frames do not fill the "
                    f"cross cache's S_ctx {plan.S_ctx} positions")
            enc_out = m.encode(params, batch["frames"])
        if ATTN in m.mixers and S > plan.S_cache and not rolling:
            raise ValueError(
                f"{cfg.name}: a prompt of {S} tokens does not fit the "
                f"decode cache's {plan.S_cache} positions (S_ctx "
                f"{plan.S_ctx}); serve it with a plan whose S_ctx holds the "
                "prompt and the tokens to generate")
        sp = topo.size(topo.sp)
        pad = -S % sp
        if pad and (RWKV in m.mixers or MAMBA in m.mixers):
            kind = "RWKV6 recurrence" if RWKV in m.mixers else "Mamba scan"
            raise ValueError(
                f"{cfg.name}: a prompt of {S} tokens does not split over the "
                f"{sp} sequence-parallel PEs, and a pad would run through "
                f"the {kind} into its final state")
        if pad:
            tokens = torch.cat((tokens, tokens.new_zeros(
                tokens.shape[:cn + 1] + (pad,))), dim=cn + 1)
        x_sp = m.embed_input(params, {**batch, "tokens": tokens})
        parts = {f"p{p}": {} for p in range(m.unit)}
        for u in range(m.n_units):
            for p in range(m.unit):
                key = f"p{p}"
                w = blocks.gather_params(m.unit_params(params, u, p),
                                         m.unit_specs[key], topo, self.dtype)
                c = {}
                if m.mixers[p] == RWKV:
                    x_sp, (c["state"], c["shift"]) = blocks.rwkv_mix(
                        cfg, topo, w, x_sp, out_cache=True)
                elif m.mixers[p] == MAMBA:
                    x_sp, (c["ssm"], c["conv"]) = blocks.mamba_mix(
                        cfg, topo, w, x_sp, out_cache=True)
                else:
                    x_sp, (c["k"], c["v"]) = blocks.attn_block(
                        cfg, topo, w, x_sp, window=int(m.windows[u, p]),
                        out_cache=True, prompt_len=S,
                        cache_len=plan.S_cache)
                    if enc_out is not None:
                        x_sp, (c["xk"], c["xv"]) = blocks.attn_block(
                            cfg, topo, w, x_sp, window=FULL_WINDOW,
                            cross_src=enc_out, prefix="x", out_cache=True,
                            prompt_len=plan.S_ctx, cache_len=plan.S_ctx)
                if m.ffns[p] == MOE:
                    x_sp, _ = blocks.moe_ffn(cfg, topo, w, x_sp)
                elif m.ffns[p] == RWKVCM:
                    x_sp, c["cm_shift"] = blocks.rwkv_channel_mix(
                        cfg, topo, w, x_sp, out_cache=True)
                else:
                    x_sp = blocks.dense_ffn(cfg, topo, w, x_sp)
                for k, t in c.items():
                    parts[key].setdefault(k, []).append(t)
        cache = {key: {k: torch.stack(v, dim=cn) for k, v in c.items()}
                 for key, c in parts.items()}
        full = topo.comm(topo.sp).all_gather(x_sp, axis=1)
        hn = rms_norm(full[..., S - 1, :], m.final_norm(params), cfg.norm_eps)
        logits = cube_matmul(hn, m._head(params), cn).float()
        return logits, cache
