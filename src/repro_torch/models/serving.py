"""Flash-decode serving over the in-process PE cube.

The counterpart of ``repro.models.serving``. Decode runs on the serve
topology (maximal model sharding, see ``build_serve_topology``):
activations are replicated over the model axes, the KV cache is
sequence-sharded over them, and every layer's partial attention (the flash
kernel's ``(acc, m, l)``) is LSE-combined with one max and two additive
all-reduces over the cache axes.

Ported: the bf16 (compute-dtype) attention cache and ``decode_shard`` for
attention layers with dense or MoE FFNs. The int8 cache, SSM / RWKV states
and ``prefill_shard`` wait for later slices.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig, ATTN, DENSE, MOE
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


def make_serve_plan(cfg: ModelConfig, topo: Topology, *, S_ctx: int,
                    global_batch: int) -> ServePlan:
    """The decode geometry; the cache is the compute-dtype one (the int8
    cache waits for its slice)."""
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
                     batch_axes=batch_axes, kv_axes=kv_axes)


# ------------------------------------------------------------- cache layout
def cache_defs(cfg: ModelConfig, topo: Topology, plan: ServePlan,
               dtype: torch.dtype = torch.bfloat16):
    """(global shape, spec, dtype) tree for the decode cache; the
    compute-dtype cache is stored in ``dtype``."""
    unit = cfg.unit()
    n_units = cfg.n_layers // unit
    B = plan.global_batch
    ba = plan.batch_axes or None
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    tree = {}
    for p, (mixer, ffn) in enumerate(zip(cfg.mixers()[:unit],
                                         cfg.ffns()[:unit])):
        if mixer != ATTN or ffn not in (DENSE, MOE):
            raise NotImplementedError(
                f"{cfg.name}: {mixer}/{ffn} decode caches are not ported to "
                "repro_torch yet")
        shp = (n_units, B, plan.S_cache, KV, hd)
        spec = (None, ba, plan.kv_axes, None, None)
        tree[f"p{p}"] = {"k": (shp, spec, dtype), "v": (shp, spec, dtype)}
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
                 dtype: torch.dtype = torch.bfloat16):
        self.cfg, self.topo, self.plan = cfg, topo, plan
        self.dtype = dtype
        self.model = Model(cfg, topo, dtype=dtype)

    def decode_shard(self, params, cache, tokens, pos):
        """One decode step. tokens, pos: (*cube, B_l) int. Writes the new
        token's K/V into ``cache`` in place and returns (logits
        (*cube, B_l, V_local) f32, cache)."""
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
                c = {k: v.select(cn, u) for k, v in cache[key].items()}
                x = blocks.attn_decode(
                    cfg, topo, w, x, c, pos, window=int(m.windows[u, p]),
                    kv_axes=plan.kv_axes, rolling=rolling, dtype=self.dtype)
                if m.ffns[p] == MOE:
                    x = blocks.moe_ffn_decode(cfg, topo, w, x)
                else:
                    x = blocks.dense_ffn_decode(cfg, topo, w, x)
        hn = rms_norm(x, m.final_norm(params), cfg.norm_eps)
        logits = cube_matmul(hn, m._head(params), cn).float()
        return logits, cache
