"""Plain PyTorch version of the flash-attention kernel (``flash.py``).

The same function as the CUDA kernel -- and as the JAX package's
``layers.chunked_attention`` / Pallas ``_flash_kernel`` -- computed in one
pass over the full score matrix: f32 softmax with the finite ``NEG_INF``
mask (a fully masked row averages v), output / max(l, 1e-30). The CPU path
of ``ops.flash_attention`` and the kernel's yardstick on the card.
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


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = -1, partial: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); q_pos: (B, Sq), k_pos:
    (B, Sk) int. Returns (B, Sq, H, hd) in q's dtype, or with ``partial``
    the f32 ``(acc (B, H, Sq, hd), m (B, H, Sq), l (B, H, Sq))``."""
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
    return out.transpose(1, 2).to(q.dtype)
