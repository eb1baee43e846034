"""Sharded transformer blocks over the in-process PE cube.

The counterpart of ``repro.models.blocks``: the same per-shard math, batched
over the cube's leading axes, with every cross-PE transfer going through a
topology-bound :class:`repro_torch.core.comm.Communicator`
(``topo.comm(axes)``). AllGather/ReduceScatter implement Megatron-style
sequence-parallel tensor parallelism, AlltoAll implements expert-parallel
MoE dispatch (one launch of the reorder kernel per all_to_all), and max and
additive all-reduces implement the flash-decode LSE combine.

Training-path activations are sequence-sharded over ``topo.sp`` between
blocks; decode-path activations are replicated over the model axes with the
KV cache sequence-sharded (flash-decode). Both attention sites run the flash
kernel (``layers.chunked_attention``).

Ported: attention (self, with the ``fused_comm`` routing through
``repro_torch.kernels.collective``, and prefill's K/V in the decode cache
layout), the dense FFN (also fused), the MoE FFN with both dispatches
(``"scatter"`` and ``"sort"``), and the RWKV6 time-mix (its recurrence on
the RWKV6 kernel, ``ssm.rwkv6_chunked``) and channel-mix with their decode
forms; the encoder-decoder's cross-attention (``attn_block(cross_src=,
prefix="x")``, ``attn_decode(cross=True)``) and the int8 KV cache (the
paper's §V-C 8-bit layout: int8 codes and one f32 scale a (slot, kv
head), read by the flash kernel's int8 decode form); the Mamba mixer
(``mamba_mix``, ``mamba_mix_decode``) of the hybrid family.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig, FULL_WINDOW
from repro_torch.models.layers import (
    rms_norm, rope, chunked_attention, finish_partial_attention,
    cube_matmul, pe_slice)
from repro_torch.models.params import dt_rank, kv_is_sharded
from repro_torch.models.topology import Topology


# ------------------------------------------------------------- param gather
def gather_params(w: dict, specs: dict, topo: Topology,
                  dtype: torch.dtype) -> dict:
    """FSDP: cast each leaf to ``dtype`` then AllGather it over ``data``
    (casting before the gather halves FSDP traffic)."""
    out = {}
    for k, v in w.items():
        spec = tuple(specs[k])
        v = v.to(dtype)
        if "data" in spec:
            v = topo.comm(("data",)).all_gather(v, axis=spec.index("data"))
        out[k] = v
    return out


# ---------------------------------------------------------------- attention
def _split_qkv(cfg: ModelConfig, topo: Topology, hn_q, hn_kv, w,
               prefix: str = ""):
    """Project and reshape q/k/v with GQA head bookkeeping. Returns
    q: (*cube, B, Sq, Hl, hd), k, v: (*cube, B, Sk, KVl, hd), and every KV
    head's (k, v) (*cube, B, Sk, KV, hd) where the heads are replicated
    over tp (None where they are sharded)."""
    cn = topo.cube.ndim
    cube = topo.cube.dim_sizes
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = topo.tp_size
    Hl = H // t
    q = cube_matmul(hn_q, w[prefix + "wq"], cn)
    B, Sq = q.shape[cn], q.shape[cn + 1]
    q = q.reshape(cube + (B, Sq, Hl, hd))
    # wkv columns are laid out (KV, 2, hd): whole kv heads stay contiguous
    # so column-sharding over tp slices whole (k, v) head pairs
    kvp = cube_matmul(hn_kv, w[prefix + "wkv"], cn)
    Sk = kvp.shape[cn + 1]
    if kv_is_sharded(cfg, topo):
        kv = kvp.reshape(cube + (B, Sk, KV // t, 2, hd))
        return q, kv[..., 0, :], kv[..., 1, :], None
    else:
        kv = kvp.reshape(cube + (B, Sk, KV, 2, hd))
        kf, vf = kv[..., 0, :], kv[..., 1, :]
        G = H // KV
        me = topo.axis_index(topo.tp, hn_q.device)
        if Hl >= G:
            cnt = Hl // G
            lo = me * cnt
        else:
            cnt = 1
            lo = (me * Hl) // G
        k = pe_slice(kf, lo, cnt, 2, cn)
        v = pe_slice(vf, lo, cnt, 2, cn)
    return q, k, v, (kf, vf)


def attn_block(cfg: ModelConfig, topo: Topology, w: dict, x_sp, *,
               window: int, causal: bool = True, cross_src=None,
               prefix: str = "", out_cache: bool = False,
               prompt_len: int = 0, cache_len: int = 0):
    """Sequence-parallel attention block. x_sp: (*cube, B, S_sp, D).

    ``cross_src``: the encoder's output (*cube, B, S_enc, D), full
    sequence, as the K/V source of the decoder's cross-attention (leaves
    named ``prefix + ...``): not causal, no window, no RoPE, no qk norm,
    and never the fused route. With ``out_cache`` it returns the cross K/V
    in the decode layout of all S_enc positions (``cache_len`` is then
    S_enc).

    ``cfg.fused_comm`` reroutes the collectives through
    ``repro_torch.kernels.collective``: the tp gather fuses the
    pre-attention norm into its ring, the context-parallel full-sequence
    gather is replaced by ring attention (kv blocks rotate over the cp ring,
    each hop on the flash kernel's partial form), and the out-projection's
    reduce_scatter becomes a lazy-tile matmul epilogue.

    ``out_cache`` (prefill; the unfused path) also returns the K/V of the
    first ``prompt_len`` positions in the decode cache's layout
    (``_decode_cache_kv``): ``cache_len`` slots sequence-sharded over tp,
    every KV head on every PE."""
    cn = topo.cube.ndim
    tpc = topo.comm(topo.tp)
    cross = cross_src is not None
    fused = cfg.fused_comm and not out_cache and not cross
    if fused:
        from repro_torch.kernels.collective import (
            all_gather_matmul, matmul_reduce_scatter, ring_attention)
        # the norm rides the tp gather ring; the cp gather disappears: k/v
        # stay chunk-local and rotate
        hn = all_gather_matmul(
            tpc, x_sp, axis=1,
            block_fn=lambda b: rms_norm(b, w["ln"], cfg.norm_eps))
        kv_src = hn                                           # (.., B, S_cp, D)
    else:
        h = tpc.all_gather(x_sp, axis=1)                      # (.., B, S_cp, D)
        hn = rms_norm(h, w[prefix + "ln"], cfg.norm_eps)
        if cross:
            kv_src, causal, window = cross_src, False, FULL_WINDOW
        elif topo.cp:
            full = topo.comm(topo.cp).all_gather(h, axis=1)   # (.., B, S, D)
            kv_src = rms_norm(full, w["ln"], cfg.norm_eps)
        else:
            kv_src = hn
    q, k, v, kv_all = _split_qkv(cfg, topo, hn, kv_src, w, prefix)
    B, Sq = q.shape[cn], q.shape[cn + 1]
    if cfg.qk_norm and not prefix:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    dev = x_sp.device
    q_off = topo.axis_index(topo.cp, dev) * Sq                # (*cube)
    if not cross:
        q = rope(q, q_off[..., None, None] + torch.arange(Sq, device=dev),
                 cfg.rope_theta)
        # fused: k is this PE's chunk, so its positions carry q's offset;
        # unfused: k is the assembled sequence from 0
        k_off = q_off[..., None, None] if fused else 0
        k = rope(k, k_off + torch.arange(k.shape[cn + 1], device=dev),
                 cfg.rope_theta)
    if fused and topo.cp:
        o = ring_attention(topo.comm(topo.cp), q, k, v, causal=causal,
                           window=window)
    else:
        o = chunked_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_off[..., None])
    o = o.reshape(topo.cube.dim_sizes + (B, Sq, -1))
    if fused:
        out = matmul_reduce_scatter(tpc, o, w["wo"], axis=1)
    else:
        out = cube_matmul(o, w[prefix + "wo"], cn)            # partial over tp
        out = tpc.reduce_scatter(out, axis=1)
    y = x_sp + out
    if not out_cache:
        return y
    if kv_all is not None:
        # replicated heads: every PE has computed all of them
        k, v = kv_all
        if cfg.qk_norm and not prefix:
            k = rms_norm(k, w["k_norm"], cfg.norm_eps)
        if not cross:
            k = rope(k, torch.arange(k.shape[cn + 1], device=dev),
                     cfg.rope_theta)
    return y, _decode_cache_kv(cfg, topo, k, v, prompt_len, cache_len)


def _cache_slots(kv, S: int, S_cache: int, cn: int):
    """The decode cache's slots from the keys of positions 0..S-1 (payload
    axis 1 of kv): slot s holds the latest position p < S with p % S_cache
    == s (the rolling rule; p itself when S <= S_cache), zeros where there
    is none."""
    kv = kv.narrow(cn + 1, 0, S)
    if S <= S_cache:
        pad = list(kv.shape)
        pad[cn + 1] = S_cache - S
        return torch.cat((kv, kv.new_zeros(pad)), dim=cn + 1)
    tail = kv.narrow(cn + 1, S - S_cache, S_cache)
    return torch.roll(tail, (S - S_cache) % S_cache, dims=cn + 1)


def _decode_cache_kv(cfg, topo, k, v, S: int, S_cache: int):
    """Prompt K/V (*cube, B, S_pad, KVl, hd), every position of the
    sequence on every PE, into the decode cache's layout: (*cube, B,
    S_cache / |tp|, KV, hd) each, slots sequence-sharded over tp with every
    KV head. Where the heads are sharded over tp, one all_to_all of K and
    V stacked splits the slots and concatenates the heads (the reorder
    kernel on the card); where they are replicated (KV < tp, or KV not a
    multiple of tp) every PE holds them all and slices its slots."""
    cn = topo.cube.ndim
    kv = _cache_slots(torch.stack((k, v), dim=cn + 2), S, S_cache, cn)
    if kv_is_sharded(cfg, topo):
        kv = topo.comm(topo.tp).all_to_all(kv, split_axis=1, concat_axis=3)
    else:
        S_loc = S_cache // topo.tp_size
        me = topo.axis_index(topo.tp, kv.device)
        kv = pe_slice(kv, me * S_loc, S_loc, 1, cn)
    return kv.select(cn + 2, 0), kv.select(cn + 2, 1)


def _write_slots(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
                 in_rng: torch.Tensor, cn: int) -> None:
    """In place: ``cache[pe, b, idx[pe, b]] = new[pe, b]`` where
    ``in_rng[pe, b]``. cache: (*cube, B, S_loc, *tail) (tail (KV, hd) of
    K/V, (KV,) of an int8 cache's scales); new: (*cube, B, *tail); idx,
    in_rng: (*cube, B)."""
    lead = tuple(cache.shape[:cn + 1])
    ix = tuple(torch.arange(s, device=cache.device).reshape(
        (1,) * a + (s,) + (1,) * (cn - a)) for a, s in enumerate(lead))
    key = ix + (idx,)
    ok = in_rng.reshape(tuple(in_rng.shape)
                        + (1,) * (new.dim() - in_rng.dim()))
    cache[key] = torch.where(ok, new.to(cache.dtype), cache[key])


def quantize_kv(x: torch.Tensor):
    """The int8 cache's codes and scales of new K or V rows (*lead, hd), as
    the reference computes them (``repro.models.blocks.attn_decode``): the
    scale ``max(absmax over hd, 1e-6) / 127`` in x's dtype, the codes
    ``round(x / scale)`` (half to even) in x's dtype, cast to int8; the
    scale is stored in f32. The codes are clamped to [-127, 127] before
    the cast: a bf16 quotient can round up to 128, which int8 does not
    hold (the reference casts it unclamped)."""
    s = torch.clamp_min(x.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.round(x / s[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, s.float()


def attn_decode(cfg: ModelConfig, topo: Topology, w: dict, x, c: dict, pos,
                *, window: int, kv_axes, rolling: bool, dtype: torch.dtype,
                prefix: str = "", cross: bool = False, keys=("k", "v")):
    """Flash-decode one token. x: (*cube, B, D) replicated over the model
    axes; c[keys[0]], c[keys[1]]: (*cube, B, S_loc, KV, hd) cache chunks,
    sequence-sharded over ``kv_axes``, written IN PLACE (the new token's
    slot); pos: (*cube, B) per-request positions. ``rolling``: cache length
    < context (sliding window), slot = pos % S_cache. Scales
    ``c[key + "_s"]`` (*cube, B, S_loc, KV) f32 mark an int8 cache: the new
    token's K/V are quantized (``quantize_kv``) and the flash kernel reads
    the codes and scales. ``cross``: the cross-attention over the encoder's
    K/V (``keys`` ("xk", "xv"), leaves ``prefix`` "x"): nothing is
    written, every slot is attended, no RoPE. Returns the new x."""
    cn = topo.cube.ndim
    cube = topo.cube.dim_sizes
    kk, vk = keys
    cache_k, cache_v = c[kk], c[vk]
    scales = (c[kk + "_s"], c[vk + "_s"]) if kk + "_s" in c else (None, None)
    tpc = topo.comm(topo.tp)
    kvc = topo.comm(kv_axes)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = x.shape[cn]
    dev = x.device
    hn = rms_norm(x.unsqueeze(-2), w[prefix + "ln"],
                  cfg.norm_eps)                                # (.., B, 1, D)
    t = topo.tp_size
    n_shards = topo.size(kv_axes)
    S_loc = cache_k.shape[cn + 1]
    my_lo = topo.axis_index(kv_axes, dev) * S_loc              # (*cube)
    slots = my_lo[..., None] + torch.arange(S_loc, device=dev)  # (*cube, S)

    # q: local columns -> gather flat then reshape (supports tp > heads)
    q = cube_matmul(hn, w[prefix + "wq"], cn)              # (.., B, 1, cols)
    q = tpc.all_gather(q, axis=2).reshape(cube + (B, 1, H, hd))
    if cross:
        # the encoder's K/V, every slot valid
        k_pos = slots[..., None, :].expand(cube + (B, S_loc))
        return _attend_decode(topo, w, x, q, cache_k, cache_v, scales, pos,
                              k_pos, kvc, causal=False, window=FULL_WINDOW,
                              prefix=prefix, dtype=dtype)
    kvp = cube_matmul(hn, w["wkv"], cn)
    if kv_is_sharded(cfg, topo):
        kvp = tpc.all_gather(kvp, axis=2)
    kvp = kvp.reshape(cube + (B, 1, KV, 2, hd))
    k_new, v_new = kvp[..., 0, :, 0, :], kvp[..., 0, :, 1, :]  # (.., B, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k_new = rms_norm(k_new, w["k_norm"], cfg.norm_eps)
    q = _rope_decode(q, pos, cfg.rope_theta)
    k_new = _rope_decode(k_new.unsqueeze(-3), pos, cfg.rope_theta).squeeze(-3)

    # write into my cache chunk
    S_cache = S_loc * n_shards
    slot = (pos % S_cache) if rolling else pos                 # (*cube, B)
    loc = slot - my_lo[..., None]
    in_rng = (loc >= 0) & (loc < S_loc)
    idx = loc.clamp(0, S_loc - 1)
    if scales[0] is not None:
        (k_new, k_s), (v_new, v_s) = quantize_kv(k_new), quantize_kv(v_new)
        _write_slots(scales[0], k_s, idx, in_rng, cn)
        _write_slots(scales[1], v_s, idx, in_rng, cn)
    _write_slots(cache_k, k_new, idx, in_rng, cn)
    _write_slots(cache_v, v_new, idx, in_rng, cn)
    # key positions of my slots
    if rolling:
        k_pos = pos[..., None] - (pos[..., None] - slots[..., None, :]) \
            % S_cache
    else:
        k_pos = slots[..., None, :].expand(cube + (B, S_loc))
    return _attend_decode(topo, w, x, q, cache_k, cache_v, scales, pos,
                          k_pos, kvc, causal=True, window=window,
                          prefix=prefix, dtype=dtype)


def _attend_decode(topo, w, x, q, cache_k, cache_v, scales, pos, k_pos, kvc,
                   *, causal: bool, window: int, prefix: str, dtype):
    """Partial attention of q (*cube, B, 1, H, hd) over my cache chunk (all
    heads; an int8 chunk with its ``scales``), LSE-combined over the shards
    of ``kvc``, then the out projection: x plus the result."""
    cn = topo.cube.ndim
    cube = topo.cube.dim_sizes
    B, H, hd = q.shape[cn], q.shape[cn + 2], q.shape[cn + 3]
    acc, m, l = chunked_attention(q, cache_k, cache_v, causal=causal,
                                  window=window, q_pos=pos[..., None],
                                  k_pos=k_pos, partial=True,
                                  k_scale=scales[0], v_scale=scales[1])
    o = finish_partial_attention(acc, m, l, comm=kvc, dtype=dtype)

    # out projection: my slice of the flattened head dim (wo row shard)
    me = topo.axis_index(topo.tp, x.device)
    rows = (H * hd) // topo.tp_size
    o_loc = pe_slice(o.reshape(cube + (B, H * hd)), me * rows, rows, 1, cn)
    out = topo.comm(topo.tp).all_reduce(
        cube_matmul(o_loc, w[prefix + "wo"], cn))
    return x + out.to(x.dtype)


def _rope_decode(q, pos, theta):
    """q: (*cube, B, 1, H, hd) at per-row positions pos (*cube, B)."""
    return rope(q, pos[..., None], theta)


# --------------------------------------------------------------------- FFNs
def _swiglu(cn, hn, wg, wu, wd):
    return cube_matmul(F.silu(cube_matmul(hn, wg, cn))
                       * cube_matmul(hn, wu, cn), wd, cn)


def dense_ffn(cfg, topo, w, x_sp):
    cn = topo.cube.ndim
    tpc = topo.comm(topo.tp)
    if cfg.fused_comm:
        from repro_torch.kernels.collective import (
            all_gather_matmul, matmul_reduce_scatter)

        def up(b):
            bn = rms_norm(b, w["fln"], cfg.norm_eps)
            return F.silu(cube_matmul(bn, w["wg"], cn)) \
                * cube_matmul(bn, w["wu"], cn)

        # norm + up-projection ride the gather ring (row-wise); the
        # down-projection's partial sum is scattered tile by tile
        h_act = all_gather_matmul(tpc, x_sp, axis=1, block_fn=up)
        return x_sp + matmul_reduce_scatter(tpc, h_act, w["wd"], axis=1)
    h = tpc.all_gather(x_sp, axis=1)
    hn = rms_norm(h, w["fln"], cfg.norm_eps)
    out = _swiglu(cn, hn, w["wg"], w["wu"], w["wd"])
    return x_sp + tpc.reduce_scatter(out, axis=1)


def dense_ffn_decode(cfg, topo, w, x):
    cn = topo.cube.ndim
    hn = rms_norm(x, w["fln"], cfg.norm_eps)
    out = _swiglu(cn, hn, w["wg"], w["wu"], w["wd"])
    return x + topo.comm(topo.tp).all_reduce(out).to(x.dtype)


# ---------------------------------------------------------------------- MoE
def _route(cfg, hn2d, router, cn: int):
    """Top-k routing per PE. hn2d: (*cube, T, D). Returns topi (*cube, T, k)
    int64, topv in hn2d's dtype, and the f32 router probabilities. Ties go
    to the lowest expert index, the rule of ``lax.top_k``."""
    logits = cube_matmul(hn2d, router, cn)
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :cfg.top_k], topi[..., :cfg.top_k]
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return topi, topv.to(hn2d.dtype), probs


def _sort_dispatch(h2, flat_e, Ep: int, C: int, k: int):
    """The "sort" dispatch (PE-assisted reordering, paper §V-A1): a stable
    argsort of the (token, choice) pairs by expert, each expert's segment
    start, and the (Ep, C) buffer built by one gather of the segments'
    first C choices. h2: (n, T, D); flat_e: (n, T * k). Returns (the
    buffer (n, Ep * C, D), each choice's rank in its expert's segment)."""
    n, Tk = flat_e.shape
    D = h2.shape[-1]
    dev = flat_e.device
    order = torch.sort(flat_e, dim=1, stable=True).indices
    sorted_e = flat_e.gather(1, order)
    starts = torch.searchsorted(
        sorted_e, torch.arange(Ep, device=dev).expand(n, Ep).contiguous())
    ends = torch.cat((starts[:, 1:], starts.new_full((n, 1), Tk)), dim=1)
    slot_idx = starts[..., None] + torch.arange(C, device=dev)  # (n, Ep, C)
    in_seg = (slot_idx < ends[..., None]).reshape(n, Ep * C)
    src = order.gather(1, slot_idx.clamp(max=Tk - 1).reshape(n, Ep * C))
    rows = h2.gather(1, (src // k)[..., None].expand(n, Ep * C, D))
    disp = torch.where(in_seg[..., None], rows, torch.zeros_like(rows))
    rank = torch.empty_like(flat_e)
    rank.scatter_(1, order, torch.arange(Tk, device=dev).expand(n, Tk)
                  - starts.gather(1, sorted_e))
    return disp, rank


def _expert_ffn(cfg, topo, w, h2, topi, topv, C: int, sort: bool = False):
    """Dispatch into (Ep, C) slots, AlltoAll over ep, the local experts,
    AlltoAll back, and the weighted combine. h2: (*cube, T, D); topi/topv:
    (*cube, T, k). A choice past its expert's capacity ``C`` is dropped:
    both dispatches rank a choice by token order within its expert, the
    "scatter" one by one-hot cumsum slots, the "sort" one
    (``_sort_dispatch``) by its place in the sorted order, so they drop
    the same choices and build the same buffer. Returns (*cube, T, D)."""
    cn = topo.cube.ndim
    lead = tuple(h2.shape[:cn])
    n = math.prod(lead)
    T, D = h2.shape[cn:]
    k, Ep = cfg.top_k, cfg.n_experts_padded
    flat_e = topi.reshape(n, T * k)
    if sort:
        disp, pos = _sort_dispatch(h2.reshape(n, T, D), flat_e, Ep, C, k)
        keep = pos < C
    else:
        oh = F.one_hot(flat_e, Ep)
        pos = (oh.cumsum(1) - oh).gather(2, flat_e[..., None])[..., 0]
        keep = pos < C
        # kept choices own distinct slots; dropped ones land in a spare row
        slot = torch.where(keep, flat_e * C + pos, Ep * C)
        disp = h2.new_zeros((n, Ep * C + 1, D))
        disp.scatter_(1, slot[..., None].expand(n, T * k, D),
                      h2.reshape(n, T, D).repeat_interleave(k, dim=1))
        disp = disp[:, :Ep * C]
    disp = disp.reshape(lead + (Ep, C, D))

    epc = topo.comm(topo.ep)
    # (Ep, C, D) -> (E_loc, ep * C, D): my experts' slots from every source
    recv = epc.all_to_all(disp, split_axis=0, concat_axis=1)
    E, R = recv.shape[cn], recv.shape[cn + 1]
    r = recv.reshape(n * E, R, D)
    wg, wu, wd = (w[key].reshape((n * E,) + tuple(w[key].shape[cn + 1:]))
                  for key in ("we_g", "we_u", "we_d"))
    hh = F.silu(torch.bmm(r, wg)) * torch.bmm(r, wu)
    oo = torch.bmm(hh, wd).reshape(lead + (E, R, D))
    if topo.size(topo.etp) > 1:
        oo = topo.comm(topo.etp).all_reduce(oo)
    back = epc.all_to_all(oo, split_axis=1, concat_axis=0)    # (Ep, C, D)

    src = (flat_e * C + pos.clamp(max=C - 1))[..., None].expand(n, T * k, D)
    vals = back.reshape(n, Ep * C, D).gather(1, src)
    vals = torch.where(keep[..., None], vals, torch.zeros_like(vals))
    vals = vals * topv.reshape(n, T * k, 1)
    return vals.reshape(n, T, k, D).sum(2).reshape(lead + (T, D))


def moe_ffn(cfg, topo, w, x_sp):
    """Expert-parallel MoE over the sequence-parallel activations
    (*cube, B, S_sp, D), with AlltoAll dispatch (``cfg.moe_dispatch``:
    "sort" sorts the choices by expert, anything else scatters them, as in
    the JAX package). Returns (new x_sp, the switch-style aux load-balance
    loss per PE (*cube))."""
    cn = topo.cube.ndim
    lead = tuple(x_sp.shape[:cn])
    etp_size = topo.size(topo.etp)
    Ep = cfg.n_experts_padded
    x_e = x_sp
    if etp_size > 1:
        x_e = topo.comm(topo.etp).all_gather(x_sp, axis=1)
    B, S_e, D = x_e.shape[cn:]
    hn = rms_norm(x_e, w["fln"], cfg.norm_eps)
    T = B * S_e
    h2 = hn.reshape(lead + (T, D))
    topi, topv, probs = _route(cfg, h2, w["router"], cn)

    # aux load-balance loss (switch-style), over the real experts only
    ne = cfg.n_experts
    pe = probs[..., :ne].mean(-2)
    fe = F.one_hot(topi.clamp(0, ne - 1).reshape(lead + (-1,)), ne).sum(-2)
    aux = ne * (pe * (fe.float() / (T * cfg.top_k))).sum(-1)

    C = int(math.ceil(T * cfg.top_k / Ep * cfg.capacity_factor))
    out = _expert_ffn(cfg, topo, w, h2, topi, topv, C,
                      sort=cfg.moe_dispatch == "sort").reshape(
        lead + (B, S_e, D))
    if cfg.n_shared_experts:
        out = out + _swiglu(cn, hn, w["ws_g"], w["ws_u"], w["ws_d"])
    if etp_size > 1:
        S_sp = x_sp.shape[cn + 1]
        me = topo.axis_index(topo.etp, x_sp.device)
        out = pe_slice(out, me * S_sp, S_sp, 1, cn)
    return x_sp + out, aux


def moe_ffn_decode(cfg, topo, w, x):
    """Decode-path MoE: tokens (*cube, B, D) replicated over the model axes;
    dispatch over ep."""
    cn = topo.cube.ndim
    B = x.shape[cn]
    Ep = cfg.n_experts_padded
    hn = rms_norm(x, w["fln"], cfg.norm_eps)
    topi, topv, _ = _route(cfg, hn, w["router"], cn)
    C = max(int(math.ceil(B * cfg.top_k / Ep * cfg.capacity_factor)), 1)
    out = _expert_ffn(cfg, topo, w, hn, topi, topv, C)
    if cfg.n_shared_experts:
        out = out + _swiglu(cn, hn, w["ws_g"], w["ws_u"], w["ws_d"])
    return x + out.to(x.dtype)


# --------------------------------------------------------------------- RWKV
def _per_pe(p: torch.Tensor, x: torch.Tensor, cn: int) -> torch.Tensor:
    """A per-PE vector p (*cube, D) shaped to broadcast against x
    (*cube, ..., D)."""
    return p.reshape(tuple(p.shape[:cn]) + (1,) * (x.dim() - cn - 1)
                     + (p.shape[-1],))


def _shift(hn: torch.Tensor) -> torch.Tensor:
    """Token shift along the sequence axis (-2): position t sees t - 1,
    position 0 sees zeros."""
    return F.pad(hn, (0, 0, 1, 0))[..., :-1, :]


def _mix(hn, prev, mu, i: int, cn: int):
    """hn + mu[i] * (prev - hn), mu: (*cube, n, D)."""
    return hn + _per_pe(mu[..., i, :], hn, cn) * (prev - hn)


def rwkv_channel_mix(cfg, topo, w, x_sp, out_cache: bool = False):
    """RWKV channel-mix over the sequence-parallel activations
    (*cube, B, S_sp, D). With ``out_cache`` also returns the last
    position's normed hidden (*cube, B, D) (decode's ``cm_shift``)."""
    cn = topo.cube.ndim
    tpc = topo.comm(topo.tp)
    h = tpc.all_gather(x_sp, axis=1)                          # (.., B, S, D)
    hn = rms_norm(h, w["fln"], cfg.norm_eps)
    prev = _shift(hn)
    xk = _mix(hn, prev, w["cm_mu"], 0, cn)
    xr = _mix(hn, prev, w["cm_mu"], 1, cn)
    kk = torch.relu(cube_matmul(xk, w["cm_k"], cn)).square()
    out = cube_matmul(kk, w["cm_v"], cn)                      # partial (tp)
    out = tpc.reduce_scatter(out, axis=1)
    gate = torch.sigmoid(cube_matmul(xr, w["cm_r"], cn))      # (.., B, S, D)
    S_sp = x_sp.shape[cn + 1]
    me = topo.axis_index(topo.tp, x_sp.device)                 # tp rank
    gate = pe_slice(gate, me * S_sp, S_sp, 1, cn)
    y = x_sp + out * gate.to(out.dtype)
    if out_cache:
        return y, hn[..., -1, :]
    return y


def rwkv_channel_mix_decode(cfg, topo, w, x, prev):
    """x, prev: (*cube, B, D), replicated over the model axes. Returns the
    new x and this token's normed hidden (the next step's ``prev``)."""
    cn = topo.cube.ndim
    hn = rms_norm(x, w["fln"], cfg.norm_eps)
    xk = _mix(hn, prev, w["cm_mu"], 0, cn)
    xr = _mix(hn, prev, w["cm_mu"], 1, cn)
    kk = torch.relu(cube_matmul(xk, w["cm_k"], cn)).square()
    out = topo.comm(topo.tp).all_reduce(cube_matmul(kk, w["cm_v"], cn))
    gate = torch.sigmoid(cube_matmul(xr, w["cm_r"], cn))
    return x + (out * gate).to(x.dtype), hn


def _rwkv_inputs(w, hn, prev, cn: int, head_shape: tuple):
    """r, k, v (head_shape), the gate g and the f32 log decays logw of the
    time-mix, from the normed hidden and its shifted copy."""
    xr, xk, xv, xg, xw = (_mix(hn, prev, w["mu"], i, cn) for i in range(5))
    r = cube_matmul(xr, w["wr"], cn).reshape(head_shape)
    k = cube_matmul(xk, w["wk"], cn).reshape(head_shape)
    v = cube_matmul(xv, w["wv"], cn).reshape(head_shape)
    g = F.silu(cube_matmul(xg, w["wg"], cn))
    lora = cube_matmul(torch.tanh(cube_matmul(xw, w["w_lora_a"], cn)),
                       w["w_lora_b"], cn)
    wdd = _per_pe(w["decay_w0"], lora, cn) + lora
    logw = -torch.exp(wdd.float()).reshape(head_shape)
    return r, k, v, g, logw


def rwkv_mix(cfg, topo, w, x_sp, out_cache: bool = False):
    """RWKV6 time-mix over the sequence-parallel activations
    (*cube, B, S_sp, D); the recurrence is one launch of the RWKV6 kernel
    over every PE's heads. With ``out_cache`` also returns (final state
    (*cube, B, Hl, hd, hd) f32, the last position's normed hidden
    (*cube, B, D)): decode's ``state`` and ``shift``."""
    cn = topo.cube.ndim
    cube = topo.cube.dim_sizes
    spc = topo.comm(topo.sp)
    h = spc.all_gather(x_sp, axis=1)                          # (.., B, S, D)
    hn = rms_norm(h, w["ln"], cfg.norm_eps)
    hd = cfg.rwkv_head_dim
    Dl = w["wr"].shape[-1]
    Hl = Dl // hd
    B, S = hn.shape[cn], hn.shape[cn + 1]
    r, k, v, g, logw = _rwkv_inputs(w, hn, _shift(hn), cn,
                                    cube + (B, S, Hl, hd))
    u = w["bonus_u"].reshape(cube + (Hl, hd))
    o, state = ssm.rwkv6_chunked(r, k, v, logw, u)
    out = cube_matmul(o.reshape(cube + (B, S, Dl)) * g, w["wo"], cn)
    out = spc.reduce_scatter(out, axis=1)                     # partial (tp)
    y = x_sp + out
    if out_cache:
        return y, (state, hn[..., -1, :])
    return y


def rwkv_mix_decode(cfg, topo, w, x, state, prev):
    """x: (*cube, B, D); state: (*cube, B, Hl, hd, hd) f32; prev:
    (*cube, B, D) the previous token's normed hidden. Returns (new x, new
    state, this token's normed hidden)."""
    cn = topo.cube.ndim
    cube = topo.cube.dim_sizes
    hn = rms_norm(x, w["ln"], cfg.norm_eps)
    hd = cfg.rwkv_head_dim
    Dl = w["wr"].shape[-1]
    Hl = Dl // hd
    B = hn.shape[cn]
    r, k, v, g, logw = _rwkv_inputs(w, hn, prev, cn, cube + (B, Hl, hd))
    u = w["bonus_u"].reshape(cube + (1, Hl, hd))
    o, state = ssm.rwkv6_step(r, k, v, logw, u, state)
    out = cube_matmul(o.reshape(cube + (B, Dl)) * g, w["wo"], cn)
    out = topo.comm(topo.tp).all_reduce(out)
    return x + out.to(x.dtype), state, hn


# -------------------------------------------------------------------- Mamba
def _mamba_inner(cfg, cn, w, xc, dbc):
    """The selective-SSM inputs from the conv's output ``xc`` and the
    tp-summed ``dbc`` (.., R + 2 N): dt (softplus of the low-rank dt
    projection plus its bias), B, C and A = -exp(a_log)."""
    R, n = dt_rank(cfg), cfg.d_state
    dt = F.softplus(cube_matmul(dbc[..., :R], w["dt_proj"], cn)
                    + _per_pe(w["dt_bias"], xc, cn))
    return dt, dbc[..., R:R + n], dbc[..., R + n:], -torch.exp(w["a_log"])


def _mamba_out(cn, w, y, xc, z):
    """(y * silu(z) + xc * D) @ out_proj: the per-PE partial over tp."""
    return cube_matmul(y * F.silu(z) + xc * _per_pe(w["d_skip"], xc, cn),
                       w["out_proj"], cn)


def mamba_mix(cfg, topo, w, x_sp, out_cache: bool = False):
    """Mamba mixer over the sequence-parallel activations (*cube, B, S_sp,
    D): gathered over sp, normed, in_proj (columns laid out (din, 2), so
    sharding them over tp slices whole (x, z) channel pairs), the causal
    conv, the selective scan over the whole sequence in f32
    (``ssm.mamba_scan_chunked``) and the out-projection, reduce-scattered
    back over sp. ``x_proj``'s output is a partial over tp, all-reduced
    before the dt / B / C split. With ``out_cache`` also returns (the final
    SSM state (*cube, B, din_l, N) f32, the conv's tail (*cube, B, K-1,
    din_l)): decode's ``ssm`` and ``conv``."""
    cn = topo.cube.ndim
    spc = topo.comm(topo.sp)
    h = spc.all_gather(x_sp, axis=1)                          # (.., B, S, D)
    hn = rms_norm(h, w["ln"], cfg.norm_eps)
    xz = cube_matmul(hn, w["in_proj"], cn)                    # (.., 2 din_l)
    xz = xz.reshape(tuple(xz.shape[:-1]) + (xz.shape[-1] // 2, 2))
    xc, conv_tail = ssm.causal_conv1d(xz[..., 0], w["conv_w"], w["conv_b"])
    xc, z = F.silu(xc), xz[..., 1]
    dbc = topo.comm(topo.tp).all_reduce(cube_matmul(xc, w["x_proj"], cn))
    dt, Bm, Cm, A = _mamba_inner(cfg, cn, w, xc, dbc)
    y, state = ssm.mamba_scan_chunked(xc, dt, A, Bm, Cm)
    out = spc.reduce_scatter(_mamba_out(cn, w, y, xc, z), axis=1)
    y_sp = x_sp + out
    if out_cache:
        return y_sp, (state, conv_tail)
    return y_sp


def mamba_mix_decode(cfg, topo, w, x, ssm_state, conv_tail):
    """x: (*cube, B, D), replicated over the model axes; ssm_state:
    (*cube, B, din_l, N) f32; conv_tail: (*cube, B, K-1, din_l). Returns
    (new x, new ssm state, new conv tail)."""
    cn = topo.cube.ndim
    tpc = topo.comm(topo.tp)
    hn = rms_norm(x, w["ln"], cfg.norm_eps)
    xz = cube_matmul(hn[..., None, :], w["in_proj"], cn)      # (.., B, 1, 2dl)
    xz = xz.reshape(tuple(xz.shape[:-1]) + (xz.shape[-1] // 2, 2))
    xc, conv_tail = ssm.causal_conv1d(xz[..., 0], w["conv_w"], w["conv_b"],
                                      conv_tail)
    xc, z = F.silu(xc)[..., 0, :], xz[..., 0, :, 1]
    dbc = tpc.all_reduce(cube_matmul(xc, w["x_proj"], cn))
    dt, Bm, Cm, A = _mamba_inner(cfg, cn, w, xc, dbc)
    y, ssm_state = ssm.mamba_step(xc, dt, A, Bm, Cm, ssm_state)
    out = tpc.all_reduce(_mamba_out(cn, w, y, xc, z))
    return x + out.to(x.dtype), ssm_state, conv_tail
