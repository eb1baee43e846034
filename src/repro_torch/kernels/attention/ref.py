"""Plain PyTorch version of the flash-attention kernel (``flash.py``).

The same function as the CUDA kernel -- and as the JAX package's
``layers.chunked_attention`` / Pallas ``_flash_kernel`` -- computed in one
pass over the full score matrix: f32 softmax with the finite ``NEG_INF``
mask (a fully masked row averages v), output / max(l, 1e-30). The CPU path
of ``ops.flash_attention`` and the kernel's yardstick on the card; beside
it the plain backward (``flash_attention_backward``), the yardstick of
``csrc/flash_bwd.cu``.
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


def dequantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 K or V (B, Sk, KV, hd) with f32 scales (B, Sk, KV) -> f32."""
    return x.float() * scale[..., None]


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = -1, partial: bool = False,
                    stats: bool = False, k_scale=None, v_scale=None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); q_pos: (B, Sq), k_pos:
    (B, Sk) int. Returns (B, Sq, H, hd) in q's dtype, or with ``partial``
    the f32 ``(acc (B, H, Sq, hd), m (B, H, Sq), l (B, H, Sq))``, or with
    ``stats`` the output and the row statistics ``(out, m, l)``. With
    ``k_scale`` / ``v_scale`` (B, Sk, KV) f32, k and v are int8 codes (the
    int8 KV cache) and attention runs on ``dequantize(k, k_scale)`` and
    ``dequantize(v, v_scale)``: the function of the kernel's int8 decode
    form."""
    if k_scale is not None:
        k, v = dequantize(k, k_scale), dequantize(v, v_scale)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, hd) * hd ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())    # (B,KV,G,Sq,Sk)
    ok = mask(q_pos, k_pos, causal, window)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                       # (B,KV,G,Sq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
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
