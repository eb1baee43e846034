"""Per-PE layer math shared by the model families, batched over the cube.

The counterpart of ``repro.models.layers``. Functions take tensors whose
leading axes may include the cube's (``(*cube.dim_sizes, ...)``): the math
is the JAX package's per-shard math broadcast over those axes.
``chunked_attention`` -- the flash-attention function -- runs on the
hand-written Hopper kernel for CUDA tensors and on its plain PyTorch version
for CPU tensors (``repro_torch.kernels.attention.ops``); under grad it goes
through ``ops.FlashAttention``, whose backward is the backward kernel.

``LOWP`` is the reference's low-precision mode (``repro.models.layers.
LOWP``), read at call time: 0 = off; 1 = bf16 operands with f32
accumulation (``rms_norm`` keeps the (.., D) tensor in bf16, attention
scales q in bf16); 2 = besides, attention's scores and probabilities stay
bf16, with f32 only for the running max, the denominator and the output
accumulator. It acts on bf16 inputs only. The attention block and ring
attention pass it to ``chunked_attention``; decode passes 0, as the
reference's decode attention computes its f32 scores itself.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.attention import ops as attention_ops

NEG_INF = -1e30

# low-precision mode: 0 = off, 1 = "lowp", 2 = "lowp2" (module docstring)
LOWP = 0


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with a ``(1 + scale)`` gain. ``scale`` is
    ``(*lead, D)`` where ``lead`` is a prefix of ``x``'s leading axes (for
    example the cube's), broadcast over the rest."""
    dt = x.dtype
    if scale.dim() < x.dim():
        scale = scale.reshape(tuple(scale.shape[:-1])
                              + (1,) * (x.dim() - scale.dim())
                              + (scale.shape[-1],))
    if LOWP >= 1 and dt == torch.bfloat16:
        # f32 only in the reduction; the (.., D) tensor stays bf16
        var = x.square().float().mean(dim=-1, keepdim=True)
        r = torch.rsqrt(var + eps) * (1.0 + scale.float())
        return x * r.to(dt)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions broadcast against
    ``x.shape[:-2]`` (e.g. (S,), (B, S) or (*cube, B, S))."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """(..., Sq, Sk) visibility from (..., Sq) query and (..., Sk) key
    positions: keys at negative positions are never visible; ``window > 0``
    bounds ``q_pos - k_pos``."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = dk >= 0
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & ((dq - dk) < window)
    return ok


def _positions(offset, n: int, lead: tuple, device) -> torch.Tensor:
    """``offset + arange(n)`` broadcast to ``(*lead, n)``; ``offset`` is an
    int or a tensor broadcastable to ``lead``."""
    off = torch.as_tensor(offset, device=device, dtype=torch.int64)
    pos = off[..., None] + torch.arange(n, device=device)
    return pos.expand(lead + (n,))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = -1, q_offset=0,
                      k_offset=0, q_pos: torch.Tensor | None = None,
                      k_pos: torch.Tensor | None = None,
                      partial: bool = False,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None, lowp: int = 0):
    """Flash attention with GQA, sliding window and global positions.

    q: (*lead, Sq, H, hd); k, v: (*lead, Sk, KV, hd), H % KV == 0. Query
    and key positions are ``q_pos`` (*lead, Sq) / ``k_pos`` (*lead, Sk), or
    ``offset + arange`` from ``q_offset``/``k_offset`` (ints, or tensors
    broadcastable to ``lead`` -- per-PE offsets of context-parallel
    prefill).

    Returns (*lead, Sq, H, hd) in q's dtype; if ``partial``, the f32
    unnormalized ``(acc (*lead, H, Sq, hd), m (*lead, H, Sq),
    l (*lead, H, Sq))`` for an LSE combine across shards (head h = kv
    head h // G, group member h % G: the JAX package's (KV, G) axes
    flattened).

    ``k_scale``, ``v_scale`` (*lead, Sk, KV) f32 mark int8 k / v (the int8
    KV cache): key j of kv head h is ``k[j, h] * k_scale[j, h]``. Only the
    decode form reads them (Sq * G <= 8 rows a kv head), and not under
    grad.

    ``lowp`` is the low-precision mode (``LOWP``) this call computes
    under; it changes bf16 q only (``ref.flash_attention``).

    Under grad it goes through ``FlashAttention``, whose forward also
    writes the row statistics the backward reads. Without grad (serving)
    it launches the forward alone: no statistics are written for a
    backward that never comes, and the output is the same bits.
    """
    lead = tuple(q.shape[:-3])
    Sq, H, hd = q.shape[-3:]
    Sk, KV = k.shape[-3], k.shape[-2]
    if q_pos is None:
        q_pos = _positions(q_offset, Sq, lead, q.device)
    if k_pos is None:
        k_pos = _positions(k_offset, Sk, lead, q.device)
    n = math.prod(lead)
    args = (q.reshape(n, Sq, H, hd).contiguous(),
            k.reshape(n, Sk, KV, hd).contiguous(),
            v.reshape(n, Sk, KV, hd).contiguous(),
            q_pos.expand(lead + (Sq,)).reshape(n, Sq).to(torch.int32),
            k_pos.expand(lead + (Sk,)).reshape(n, Sk).to(torch.int32))
    scales = {}
    if k_scale is not None:
        scales = {"k_scale": k_scale.reshape(n, Sk, KV).contiguous(),
                  "v_scale": v_scale.reshape(n, Sk, KV).contiguous()}
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if scales:
            raise NotImplementedError(
                "chunked_attention over an int8 cache under grad: the int8 "
                "KV cache is a decode-time layout")
        if partial:
            raise NotImplementedError(
                "chunked_attention(partial=True) under grad: the partial "
                "form is fused_comm's ring attention over cp, and no "
                "training path reaches it, since loss_shard refuses "
                "context parallelism as the reference's does (fused_comm "
                "training at cp 1 runs the full form)")
        out = attention_ops.FlashAttention.apply(*args, causal, window,
                                                 lowp)
        return out.reshape(lead + (Sq, H, hd))
    res = attention_ops.flash_attention(*args, causal=causal, window=window,
                                        partial=partial, lowp=lowp, **scales)
    if partial:
        acc, m, l = res
        return (acc.reshape(lead + (H, Sq, hd)), m.reshape(lead + (H, Sq)),
                l.reshape(lead + (H, Sq)))
    return res.reshape(lead + (Sq, H, hd))


def finish_partial_attention(acc, m, l, *, comm, dtype):
    """LSE-combine ``partial=True`` results across the shards of ``comm``
    (a communicator bound to the flash-decode axes): one max and two
    additive all-reduces. Returns (..., Sq, H, hd) in ``dtype``."""
    m_max = comm.all_reduce(m, op="max")
    w = torch.exp(m - m_max)
    acc = comm.all_reduce(acc * w[..., None])
    l = comm.all_reduce(l * w)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(-3, -2).to(dtype)


# --------------------------------------------------------- cube helpers
def cube_matmul(x: torch.Tensor, w: torch.Tensor,
                cube_ndim: int) -> torch.Tensor:
    """Per-PE ``x @ w``: x (*cube, ..., K), w (*cube, K, N)."""
    n = math.prod(x.shape[:cube_ndim])
    K, N = w.shape[-2], w.shape[-1]
    out = torch.bmm(x.reshape(n, -1, K), w.reshape(n, K, N))
    return out.reshape(tuple(x.shape[:-1]) + (N,))


def pe_slice(x: torch.Tensor, start: torch.Tensor, size: int, axis: int,
             cube_ndim: int) -> torch.Tensor:
    """Per-PE ``dynamic_slice_in_dim``: PE c takes ``size`` entries of its
    payload ``axis`` from ``start[c]`` (start: an int tensor of shape
    ``cube.dim_sizes``)."""
    d = cube_ndim + axis
    rest = x.dim() - cube_ndim
    shape = [1] * x.dim()
    shape[d] = size
    idx = (start.reshape(tuple(start.shape) + (1,) * rest)
           + torch.arange(size, device=x.device).reshape(shape))
    out_shape = list(x.shape)
    out_shape[d] = size
    return torch.gather(x, d, idx.expand(out_shape))
