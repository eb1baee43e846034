"""Plain PyTorch version of the RWKV6 kernel (``rwkv6.py``).

The chunked form of ``repro.models.ssm.rwkv6_chunked`` (the JAX package's
oracle of the Pallas ``_rwkv_kernel``), with the state in and out and the
same chunk rule. Per step, o_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t and
S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T; inside a chunk the products
are taken relative to the chunk's start (k_s e^{-cum_s} against
r_t e^{cum_{t-1}}). The CPU path of ``ops.rwkv6_chunked`` and the kernel's
yardstick on the card.

``chunk_states`` and ``rwkv6_chunked_backward`` are the plain versions of
the forward kernel's saved states (every 64 steps) and of the backward
kernel (``rwkv6_bwd.py``): the same two passes over the kernels' 16-step
sub-chunks -- the state's gradient at each 64-step chunk's end
(``state_grads``), then each chunk on its own from its two boundary
tensors (``chunk_grads``).
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


SUB = 16    # the kernels' sub-chunk: e^{-cum} stays far from f32's limit
SAVE = 64   # the forward saves its state every SAVE steps for the backward
_PER = SAVE // SUB


def _pad_steps(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B, S, H, K) as f32 (B, n, SUB, H, K), zero steps past S: a zero
    step carries no r, k, v or do and decays by e^0 = 1."""
    B, S = x.shape[:2]
    x = x.float()
    if n * SUB != S:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n * SUB - S))
    return x.reshape((B, n, SUB) + tuple(x.shape[2:]))


def _advance(st, kc, vc, lc):
    """The state after one sub-chunk (kc, vc, lc: (B, SUB, H, K)) from st,
    the state at its start: S <- e^{tot} S + kw^T v."""
    cum = lc.cumsum(1)
    tot = cum[:, -1]
    return torch.exp(tot)[..., None] * st + torch.einsum(
        "bshk,bshv->bhkv", kc * torch.exp(tot[:, None] - cum), vc)


def _retreat(dS, rc, lc, dc):
    """The gradient of a sub-chunk's start state from dS, its end state's:
    dS <- e^{tot} dS + qd^T do, with qd = r e^{excl}."""
    cum = lc.cumsum(1)
    tot = cum[:, -1]
    return torch.exp(tot)[..., None] * dS + torch.einsum(
        "bthk,bthv->bhkv", rc * torch.exp(cum - lc), dc)


def chunk_states(k, v, logw, state=None) -> torch.Tensor:
    """The f32 state at the start of each SAVE-step chunk, (B, H,
    ceil(S / SAVE), K, V): what the forward kernel saves for the backward.
    Entry 0 is the incoming state (zeros for None). The state advances by
    SUB-step sub-chunks, as in the kernels."""
    B, S, H, K = k.shape
    V = v.shape[-1]
    n = -(-S // SUB)
    kf, vf, lw = (_pad_steps(x, n) for x in (k, v, logw))
    st = (torch.zeros((B, H, K, V), dtype=torch.float32, device=k.device)
          if state is None else state.float())
    out = []
    for i in range(n):
        if i % _PER == 0:
            out.append(st)
        st = _advance(st, kf[:, i], vf[:, i], lw[:, i])
    return torch.stack(out, 2)


def state_grads(r, logw, do, dstate=None):
    """Pass 1 of the backward: the sub-chunks last to first, carrying only
    the state's gradient (``_retreat``). Returns (ends, d0): ends (B, H,
    ceil(S / SAVE), K, V) f32, entry c the gradient of the state at the
    end of SAVE-step chunk c (the last entry is dstate, zeros for None),
    and d0 the gradient of the state at step 0."""
    B, S, H, K = r.shape
    V = do.shape[-1]
    n = -(-S // SUB)
    rf, lw, dof = (_pad_steps(x, n) for x in (r, logw, do))
    dS = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
          if dstate is None else dstate.float())
    ends = [None] * -(-n // _PER)
    for i in reversed(range(n)):
        if i == n - 1 or i % _PER == _PER - 1:
            ends[i // _PER] = dS
        dS = _retreat(dS, rf[:, i], lw[:, i], dof[:, i])
    return torch.stack(ends, 2), dS


def chunk_grads(r, k, v, logw, u, states, do, ends, order=None):
    """Pass 2 of the backward: each SAVE-step chunk on its own, from its
    saved start state (``states``, ``chunk_states``) and the gradient of
    its end state (``ends``, ``state_grads``). A chunk rebuilds its inner
    sub-chunk start states with ``_advance``, then sweeps its sub-chunks
    last to first. ``order``: the chunks' order (any permutation of
    range(ceil(S / SAVE)); no chunk reads another's result). Returns (dr,
    dk, dv in r's dtype, dlogw f32, du_parts (B, H, ceil(S / SAVE), K) f32,
    each chunk's sum of r k dD).

    Per sub-chunk, with dS the gradient of its end state and S0 its start
    state (cum inclusive, excl = cum - logw, tot = cum at the last step;
    qd = r e^{excl}, kd = k e^{-cum}, kw = k e^{tot - cum}; P[t, s] =
    qd_t . kd_s and dP[t, s] = do_t . v_s for s < t; D_t = r_t . (u k_t),
    dD_t = do_t . v_t):
      dqd_t = S0 do_t + sum_{s<t} dP[t, s] kd_s
      dkd_s = sum_{t>s} dP[t, s] qd_t,   dkw_s = dS v_s
      dv_s  = sum_{t>s} P[t, s] do_t + D_s do_s + dS^T kw_s
      dr = dqd e^{excl} + u k dD,  dk = dkd e^{-cum} + dkw e^{tot-cum}
           + u r dD,  du += sum_t r_t k_t dD_t
      dlogw_tau = sum_{t>=tau} a_t + sum_{t>tau} b_t + dtot, with a =
           -(dkd kd + dkw kw) (through cum), b = dqd qd (through excl),
           dtot = sum_s dkw_s kw_s + e^{tot} rowsum(S0 * dS)
      dS <- e^{tot} dS + sum_t qd_t do_t^T
    the gradient of the inclusive cumulative log-decay summed back over
    the sub-chunk (the identity of chunked gated-linear-attention
    backwards), plus the state's term."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    n = -(-S // SUB)
    nc = -(-n // _PER)
    rf, kf, vf, lw, dof = (_pad_steps(x, n) for x in (r, k, v, logw, do))
    uf = _u_rows(u, B)[:, None]                         # (B, 1, H, K)
    below = torch.tril(torch.ones((SUB, SUB), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    zero = torch.zeros((), device=r.device)
    grads = {name: [None] * n for name in ("r", "k", "v", "w")}
    du_parts = [None] * nc
    for c in (range(nc) if order is None else order):
        subs = range(c * _PER, min((c + 1) * _PER, n))
        starts = [states[:, :, c].float()]
        for i in subs[:-1]:
            starts.append(_advance(starts[-1], kf[:, i], vf[:, i], lw[:, i]))
        dS = ends[:, :, c].float()
        du = torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
        for i in reversed(subs):
            rc, kc, vc, lc, dc = (x[:, i] for x in (rf, kf, vf, lw, dof))
            S0 = starts[i - c * _PER]
            cum = lc.cumsum(1)
            excl = cum - lc
            tot = cum[:, -1]                            # (B, H, K)
            qd = rc * torch.exp(excl)
            kd = kc * torch.exp(-cum)
            kw = kc * torch.exp(tot[:, None] - cum)
            P = torch.where(below, torch.einsum("bthk,bshk->bhts", qd, kd),
                            zero)
            dP = torch.where(below, torch.einsum("bthv,bshv->bhts", dc, vc),
                             zero)
            D = (rc * uf * kc).sum(-1)                  # (B, C, H)
            dD = (dc * vc).sum(-1)
            dqd = (torch.einsum("bhkv,bthv->bthk", S0, dc)
                   + torch.einsum("bhts,bshk->bthk", dP, kd))
            dkd = torch.einsum("bhts,bthk->bshk", dP, qd)
            dkw = torch.einsum("bhkv,bshv->bshk", dS, vc)
            grads["v"][i] = (torch.einsum("bhts,bthv->bshv", P, dc)
                             + D[..., None] * dc
                             + torch.einsum("bshk,bhkv->bshv", kw, dS))
            grads["r"][i] = dqd * torch.exp(excl) + uf * kc * dD[..., None]
            grads["k"][i] = (dkd * torch.exp(-cum)
                             + dkw * torch.exp(tot[:, None] - cum)
                             + uf * rc * dD[..., None])
            du = du + (rc * kc * dD[..., None]).sum(1)
            a = -(dkd * kd) - dkw * kw
            b = dqd * qd
            dtot = (dkw * kw).sum(1) + torch.exp(tot) * (S0 * dS).sum(-1)
            grads["w"][i] = ((a + b).flip(1).cumsum(1).flip(1) - b
                             + dtot[:, None])
            dS = torch.exp(tot)[..., None] * dS + torch.einsum(
                "bthk,bthv->bhkv", qd, dc)
        du_parts[c] = du

    def steps(parts, width):
        return torch.stack(parts, 1).reshape(B, n * SUB, H, width)[:, :S]

    dr, dk = (steps(grads[x], K).to(r.dtype) for x in ("r", "k"))
    return (dr, dk, steps(grads["v"], V).to(r.dtype), steps(grads["w"], K),
            torch.stack(du_parts, 2))


def rwkv6_chunked_backward(r, k, v, logw, u, state, do, dstate=None,
                           states=None):
    """The gradient of ``rwkv6_chunked`` by the backward kernel's
    algorithm: ``state_grads`` (pass 1), then ``chunk_grads`` (pass 2),
    then du summed over the chunks and the rows that share a u. r, k, v,
    logw, u, state: the forward's inputs; do: (B, S, H, V), the output's
    gradient; dstate: (B, H, K, V) the final state's, or None (zeros);
    states: ``chunk_states`` of the forward (computed here when None).
    Returns (dr, dk, dv in r's dtype, dlogw f32, du in u's dtype,
    dstate_in f32 or None when no state came in)."""
    B, S, H, K = r.shape
    if states is None:
        states = chunk_states(k, v, logw, state)
    ends, d0 = state_grads(r, logw, do, dstate)
    dr, dk, dv, dlogw, du_parts = chunk_grads(r, k, v, logw, u, states, do,
                                              ends)
    du = du_parts.sum(2)
    if u.dim() == 3:
        du = du.reshape((u.shape[0], B // u.shape[0], H, K)).sum(1)
    else:
        du = du.sum(0)
    return (dr, dk, dv, dlogw, du.to(u.dtype),
            None if state is None else d0)
