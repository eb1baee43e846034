"""Plain PyTorch version of the flash-attention kernel (``flash.py``).

The same function as the CUDA kernel -- and as the JAX package's
``layers.chunked_attention`` / Pallas ``_flash_kernel`` -- computed in one
pass over the full score matrix: f32 softmax with the finite ``NEG_INF``
mask (a fully masked row averages v), output / max(l, 1e-30). The CPU path
of ``ops.flash_attention`` and the kernel's yardstick on the card; beside
it the plain backwards of the full and the partial form
(``flash_attention_backward``, ``flash_attention_partial_backward``), the
yardsticks of ``csrc/flash_bwd.cu``.

Under a low-precision mode (``lowp``, the reference's ``LOWP``) on bf16 q
it computes the reference's forms instead: 1 scales q in bf16 (``bf16(q *
bf16(scale))``) and dots it with bf16 k in f32, and rounds p to bf16 for
p v; 2 also rounds the scores to bf16 (masked ones to ``bf16(-1e30)``) and
takes p against the reference's running max over its key chunks: the
``Sk`` keys split into ``nc = max(Sk // min(1024, Sk), 1)`` chunks of ``C =
Sk // nc`` (where ``nc`` does not divide ``Sk`` the last chunk takes the
remainder; the reference's reshape needs it to divide), and a key of chunk
c has p = ``bf16(exp(bf16(s - bf16(M_c))))``, M_c the f32 max of the
scores of chunks 0 .. c (at least -1e30); l and acc sum ``p * exp(M_c -
m)`` in f32, m the row's max (M of the last chunk). Below 2,048 keys that
is one chunk, p against the row's max. f32 q ignores the mode, as the
reference's does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
         window: int) -> torch.Tensor:
    """(B, Sq, Sk) visibility: k_pos >= 0; k_pos <= q_pos when causal;
    q_pos - k_pos < window when window > 0."""
    dq = q_pos[:, :, None].long()
    dk = k_pos[:, None, :].long()
    ok = dk >= 0
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & ((dq - dk) < window)
    return ok


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), back in f32."""
    return x.to(torch.bfloat16).float()


def bf16_scalar(x: float) -> float:
    """``x`` rounded to bf16, as a Python float."""
    return float(torch.tensor(x).bfloat16())


def lowp_chunks(Sk: int) -> tuple[int, int]:
    """``(nc, C)``: the reference's key chunks under mode 2, ``nc`` chunks
    of ``C`` keys, the last one taking any remainder."""
    nc = max(Sk // min(1024, Sk), 1)
    return nc, Sk // nc


def chunk_max(s: torch.Tensor) -> torch.Tensor:
    """Mode 2: for scores ``s`` (..., Sk), each key's M_c, the running max
    over the chunks up to its own (``lowp_chunks``), at least -1e30."""
    Sk = s.shape[-1]
    nc, C = lowp_chunks(Sk)
    head = (nc - 1) * C
    cm = torch.cat([s[..., :head].reshape(s.shape[:-1] + (nc - 1, C))
                    .amax(-1), s[..., head:].amax(-1, keepdim=True)], -1)
    cm = cm.clamp_min(NEG_INF).cummax(-1).values           # (..., nc)
    return torch.cat([cm[..., :-1, None].expand(s.shape[:-1] + (nc - 1, C))
                      .reshape(s.shape[:-1] + (head,)),
                      cm[..., -1:].expand(s.shape[:-1] + (Sk - head,))], -1)


def dequantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 K or V (B, Sk, KV, hd) with f32 scales (B, Sk, KV) -> f32."""
    return x.float() * scale[..., None]


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = -1, partial: bool = False,
                    stats: bool = False, k_scale=None, v_scale=None,
                    lowp: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); q_pos: (B, Sq), k_pos:
    (B, Sk) int; k, v (and the scales) may also be (C, B_l, Sk, KV, hd)
    with C * B_l = B, the kernel's strided lead (``flash.lead_strides``),
    read as the (B, Sk, KV, hd) they flatten to. Returns (B, Sq, H, hd) in
    q's dtype, or with ``partial``
    the f32 ``(acc (B, H, Sq, hd), m (B, H, Sq), l (B, H, Sq))``, or with
    ``stats`` the output and the row statistics ``(out, m, l)``. With
    ``k_scale`` / ``v_scale`` (B, Sk, KV) f32, k and v are int8 codes (the
    int8 KV cache) and attention runs on ``dequantize(k, k_scale)`` and
    ``dequantize(v, v_scale)``: the function of the kernel's int8 decode
    form. ``lowp`` 1 / 2: the low-precision forms on bf16 q (module
    docstring); the int8 cache takes none."""
    if k_scale is not None:
        if lowp:
            raise ValueError("flash_attention: the int8 KV cache takes no "
                             f"low-precision mode, got lowp={lowp}")
        k, v = (dequantize(t, sc.reshape(t.shape[:-1]))
                for t, sc in ((k, k_scale), (v, v_scale)))
    lowp = lowp if q.dtype == torch.bfloat16 else 0
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[-3], k.shape[-2]
    G = H // KV
    # K / V in f32 (B, Sk, KV, hd): a bf16 or int8 input with a strided
    # lead is read where it lies by the conversion, whose result is
    # contiguous, so the reshape after it is a view
    k, v = (t.float().reshape(B, Sk, KV, hd) for t in (k, v))
    if lowp:
        qf = bf16(q.float() * bf16_scalar(hd ** -0.5))
    else:
        qf = q.float() * hd ** -0.5
    qf = qf.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k)            # (B,KV,G,Sq,Sk)
    ok = mask(q_pos, k_pos, causal, window)[:, None, None]
    if lowp >= 2:
        s = torch.where(ok, bf16(s), bf16_scalar(NEG_INF))
        mc = chunk_max(s)                                    # (B,KV,G,Sq,Sk)
        m = mc[..., -1]                                      # (B,KV,G,Sq)
        p = bf16(torch.exp(bf16(s - bf16(mc)))) * torch.exp(mc - m[..., None])
    else:
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)                                   # (B,KV,G,Sq)
        p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskh->bkgqh", bf16(p) if lowp == 1 else p, v)
    acc, m, l = (acc.reshape(B, H, Sq, hd), m.reshape(B, H, Sq),
                 l.reshape(B, H, Sq))
    if partial:
        return acc, m, l
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.transpose(1, 2).to(q.dtype)
    return (out, m, l) if stats else out


def flash_attention_backward(q, k, v, o, m, l, do, q_pos, k_pos, *,
                             causal: bool = True, window: int = -1):
    """The backward of ``flash_attention`` (the function of
    ``csrc/flash_bwd.cu``): from the inputs, the output ``o``, its row
    statistics ``m``, ``l`` (f32 (B, H, Sq)) and the output's cotangent
    ``do``, the cotangents ``(dq, dk, dv)`` in the inputs' dtypes. All in
    f32: p = exp(s - m) / max(l, 1e-30) with masked scores at NEG_INF (a
    row that sees no key has p = 1 / Sk everywhere, so dv gets do / Sk and
    dq / dk nothing), D = rowsum(do * o), ds = p (do v^T - D) on visible
    pairs, dq = scale ds k, dk = scale ds^T q, dv = p^T do, summed over the
    G query heads of a kv head."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf * scale, kf)   # (B,KV,G,Sq,Sk)
    ok = mask(q_pos, k_pos, causal, window)[:, None, None]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    mm = m.reshape(B, KV, G, Sq)[..., None]
    li = 1.0 / torch.clamp_min(l.reshape(B, KV, G, Sq), 1e-30)[..., None]
    p = torch.exp(s - mm) * li
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    delta = (dof * o.float().reshape(B, Sq, KV, G, hd)).sum(-1)  # (B,Sq,KV,G)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    ds = torch.where(ok, ds, torch.zeros_like(ds))
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_partial_backward(q, k, v, m, dacc, dl, q_pos, k_pos, *,
                                     causal: bool = True, window: int = -1):
    """The backward of ``flash_attention(partial=True)`` with its row max m
    held fixed (the function of ``csrc/flash_bwd.cu``'s partial form): from
    the inputs, m (f32 (B, H, Sq)) and the cotangents of acc (f32 (B, H,
    Sq, hd)) and of l (f32 (B, H, Sq)), the cotangents ``(dq, dk, dv)`` in
    the inputs' dtypes. All in f32: p = exp(s - m) with masked scores at
    NEG_INF (a row that sees no key has m = -1e30 and p = 1 on every key),
    ds = p (dacc v^T + dl) on visible pairs, dq = scale ds k, dk = scale
    ds^T q, dv = p^T dacc, summed over the G query heads of a kv head.

    Exact for any loss that depends on (acc, m, l) only through ``acc e^m``
    and ``l e^m``, as the LSE merges of ring attention and of
    ``finish_partial_attention`` do: there the cotangent of m equals
    ``dacc . acc + dl l``, and the total derivative through m is zero."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    da = dacc.float().reshape(B, KV, G, Sq, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf * scale, kf)   # (B,KV,G,Sq,Sk)
    ok = mask(q_pos, k_pos, causal, window)[:, None, None]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - m.reshape(B, KV, G, Sq)[..., None])
    dv = torch.einsum("bkgqs,bkgqh->bskh", p, da)
    dp = torch.einsum("bkgqh,bskh->bkgqs", da, vf)
    ds = p * (dp + dl.reshape(B, KV, G, Sq)[..., None])
    ds = torch.where(ok, ds, torch.zeros_like(ds))
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
