"""Plain PyTorch version of the RWKV6 kernel (``rwkv6.py``).

The chunked form of ``repro.models.ssm.rwkv6_chunked`` (the JAX package's
oracle of the Pallas ``_rwkv_kernel``), with the state in and out and the
same chunk rule. Per step, o_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t and
S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T; inside a chunk the products
are taken relative to the chunk's start (k_s e^{-cum_s} against
r_t e^{cum_{t-1}}). The CPU path of ``ops.rwkv6_chunked`` and the kernel's
yardstick on the card.
"""
from __future__ import annotations

import torch


def chunk_len(S: int, chunk: int = 64) -> int:
    """The chunk length of ``ssm.rwkv6_chunked``: ``S`` split into
    ``S // min(chunk, S)`` equal chunks; raises when they do not cover it
    (S = 129 with chunk 64)."""
    C = min(chunk, S)
    n = S // C
    C = S // n
    if n * C != S:
        raise ValueError(f"rwkv6_chunked: {S} steps do not split into {n} "
                         f"chunks of {C}")
    return C


def _u_rows(u: torch.Tensor, N: int) -> torch.Tensor:
    """u (H, K) or (G, H, K) as (N, H, K) f32: row n reads u[n // (N/G)]."""
    u = u.float()
    if u.dim() == 2:
        return u.expand((N,) + tuple(u.shape))
    G = u.shape[0]
    if N % G:
        raise ValueError(f"rwkv6_chunked: {G} rows of u do not divide a "
                         f"batch of {N}")
    return u[:, None].expand((G, N // G) + tuple(u.shape[1:])).reshape(
        (N,) + tuple(u.shape[1:]))


def rwkv6_chunked(r, k, v, logw, u, state=None, chunk: int = 64):
    """r, k, logw: (B, S, H, K); v: (B, S, H, V); u: (H, K), or (G, H, K)
    with G dividing B (batch row n takes u[n // (B/G)]); state: (B, H, K,
    V) or None (zeros). Returns (o (B, S, H, V) in r's dtype, final state
    (B, H, K, V) f32); all arithmetic in f32."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    C = chunk_len(S, chunk)
    n = S // C
    rf, kf, lw = (x.float().reshape(B, n, C, H, K) for x in (r, k, logw))
    vf = v.float().reshape(B, n, C, H, V)
    uf = _u_rows(u, B)
    S0 = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    below = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                       diagonal=-1)
    outs = []
    for i in range(n):
        rc, kc, vc, lc = rf[:, i], kf[:, i], vf[:, i], lw[:, i]
        cum = lc.cumsum(1)                          # inclusive logs
        qd = rc * torch.exp(cum - lc)               # r_t e^{cum_{t-1}}
        kd = kc * torch.exp(-cum)                   # k_s e^{-cum_s}
        A = torch.einsum("bchk,bshk->bhcs", qd, kd)
        A = torch.where(below, A, torch.zeros_like(A))
        diag = torch.einsum("bchk,bhk,bchk->bch", rc, uf, kc)   # s == t
        o = (torch.einsum("bchk,bhkv->bchv", qd, S0)
             + torch.einsum("bhcs,bshv->bchv", A, vc)
             + diag[..., None] * vc)
        outs.append(o)
        tot = cum[:, -1]                            # (B, H, K)
        S0 = torch.exp(tot)[..., None] * S0 + torch.einsum(
            "bshk,bshv->bhkv", kc * torch.exp(tot[:, None] - cum), vc)
    out = torch.stack(outs, 1).reshape(B, S, H, V)
    return out.to(r.dtype), S0
