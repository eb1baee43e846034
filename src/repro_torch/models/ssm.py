"""Sequence-mixing recurrences: RWKV6 ("Finch", data-dependent decay linear
attention with a per-head matrix state) and Mamba (the selective SSM of the
hybrid family) with its depthwise causal conv.

The counterpart of ``repro.models.ssm``. ``rwkv6_chunked`` runs the
chunked form on the hand-written Hopper kernel for CUDA tensors and on its
plain PyTorch version for CPU tensors (``repro_torch.kernels.rwkv6.ops``);
leading axes (the cube's PEs and the batch) fold into the kernel's batch,
so a layer is one launch. Under autograd it goes through
``ops.RWKV6Chunked``, whose backward is the RWKV6 backward kernel.
Decode takes the one-token ``rwkv6_step``, plain math as in the JAX
package. The Mamba functions (``mamba_scan_chunked``, ``mamba_step``,
``causal_conv1d``) are jnp in the reference, with no Pallas kernel, and
plain PyTorch here, with the reference's chunking and f32 carry.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rwkv6 import ops as rwkv6_ops


def rwkv6_chunked(r, k, v, logw, u, state=None):
    """RWKV6 time-mix recurrence, chunked.

    r, k, logw: (*lead, S, H, K); v: (*lead, S, H, V); logw = -exp(w_dd)
    <= 0 (per-channel log decay); u: (*ulead, H, K) bonus, ``ulead`` a
    prefix of ``lead`` (e.g. the cube's axes: one u per PE); state:
    (*lead, H, K, V) f32 or None.

    Per step: o_t = (S_{t-1} + (u*k_t) v_t^T)^T r_t ; S_t = diag(w_t)
    S_{t-1} + k_t v_t^T. Returns (out (*lead, S, H, V) in r's dtype,
    final state (*lead, H, K, V) f32).
    """
    lead = tuple(r.shape[:-3])
    S, H, K = r.shape[-3:]
    V = v.shape[-1]
    ulead = tuple(u.shape[:-2])
    if lead[:len(ulead)] != ulead:
        raise ValueError(f"rwkv6_chunked: u's leading axes {ulead} are not "
                         f"a prefix of {lead}")
    N = math.prod(lead)
    if ulead:
        u = u.reshape((math.prod(ulead), H, K))
    o, state = rwkv6_ops.rwkv6_chunked(
        r.reshape(N, S, H, K).contiguous(),
        k.reshape(N, S, H, K).contiguous(),
        v.reshape(N, S, H, V).contiguous(),
        logw.reshape(N, S, H, K).contiguous(), u.contiguous(),
        None if state is None else state.reshape(N, H, K, V).contiguous())
    return o.reshape(lead + (S, H, V)), state.reshape(lead + (H, K, V))


def rwkv6_step(r, k, v, logw, u, state):
    """Single-token decode. r, k, v, logw: (*lead, H, K); u broadcastable
    to (*lead, H, K); state: (*lead, H, K, V) f32."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    w = torch.exp(logw.float())
    kv = kf[..., :, None] * vf[..., None, :]               # (.., H, K, V)
    o = torch.einsum("...k,...kv->...v", rf,
                     state + u.float()[..., None] * kv)
    new_state = w[..., None] * state + kv
    return o.to(r.dtype), new_state


def rwkv6_reference(r, k, v, logw, u, state=None):
    """Naive sequential oracle (tests only). r, k, v, logw: (B, S, H, K);
    u: (H, K) or (B, H, K)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    if state is None:
        state = torch.zeros((B, H, K, V), dtype=torch.float32,
                            device=r.device)
    outs = []
    for t in range(S):
        o, state = rwkv6_step(r[:, t], k[:, t], v[:, t], logw[:, t], u,
                              state)
        outs.append(o)
    return torch.stack(outs, dim=1), state


# ----------------------------------------------------------------- Mamba
def _lead(t: torch.Tensor, nd: int, tail: int) -> torch.Tensor:
    """``t`` (*tlead, *last ``tail`` axes) with ones inserted after its
    leading axes so that it has ``nd`` axes: a per-PE (or global) weight
    broadcast against an activation whose leading axes begin with
    ``tlead``."""
    lead = tuple(t.shape[:t.dim() - tail])
    return t.reshape(lead + (1,) * (nd - t.dim()) + tuple(t.shape[len(lead):]))


# the chunks scanned at once: as many as keep one (*lead, g, C, Din, N) f32
# term under this many bytes (the reference scans one chunk at a time)
GROUP_BYTES = 1 << 29


def _scan_group(h0, uc, dc, bc, cc, A):
    """g chunks of the selective scan, f32. h0: (*lead, Din, N); uc, dc:
    (*lead, g, C, Din); bc, cc: (*lead, g, C, N); A: broadcastable to
    (*lead, g, C, Din, N). Within each chunk the linear recurrence h_t =
    da_t h_{t-1} + db_t is an inclusive scan under the reference's combine
    ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``, taken for all g chunks
    at once in log2(C) doubling steps (each combines every position with
    the one ``shift`` before it in its chunk): only products of decays in
    (0, 1] are formed, so strong decay underflows towards 0 and never
    overflows. The carry then runs through the chunks in order, each
    chunk's start state the last one's ``aa[-1] h0 + bb[-1]``, as the
    reference carries ``h[:, -1]``. Returns (the last chunk's end state, y
    (*lead, g * C, Din))."""
    da = torch.exp(dc[..., None] * A)                      # (.., g, C, Din, N)
    db = dc[..., None] * bc[..., None, :] * uc[..., None]
    C = da.shape[-3]
    shift = 1
    while shift < C:
        a_cur = da[..., shift:, :, :]
        db = torch.cat((db[..., :shift, :, :],
                        torch.addcmul(db[..., shift:, :, :], a_cur,
                                      db[..., :C - shift, :, :])), dim=-3)
        da = torch.cat((da[..., :shift, :, :],
                        a_cur * da[..., :C - shift, :, :]), dim=-3)
        shift *= 2
    starts = []
    for i in range(da.shape[-4]):
        starts.append(h0)
        h0 = torch.addcmul(db[..., i, -1, :, :], da[..., i, -1, :, :], h0)
    h = torch.addcmul(db, da, torch.stack(starts, dim=-3)[..., None, :, :])
    y = torch.einsum("...gcdn,...gcn->...gcd", h, cc)
    return h0, y.flatten(-3, -2)


def mamba_scan_chunked(u, delta, A, Bm, Cm, state=None, chunk: int = 32):
    """Selective SSM: h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t;
    y_t = C_t . h_t.

    u, delta: (*lead, S, Din); A: (*alead, Din, N), ``alead`` a prefix of
    ``lead`` (e.g. the cube's axes: one A per PE); Bm, Cm: (*lead, S, N);
    state: (*lead, Din, N) f32 or None. Chunked as the reference: chunks
    of ``min(chunk, S)`` steps re-fitted to divide S (S must split into
    them), an associative scan within a chunk and a sequential f32 carry
    across chunks. The chunks go through ``_scan_group`` in groups of up
    to GROUP_BYTES a term; under autograd each group runs under a
    checkpoint (the reference checkpoints each chunk): the backward keeps
    only the carry between groups and recomputes a group's O(g C Din N)
    terms. Returns (y (*lead, S, Din) in u's dtype, final state (*lead,
    Din, N) f32)."""
    S, Din = u.shape[-2:]
    N = A.shape[-1]
    C = min(chunk, S)
    n = S // C
    C = S // n
    if n * C != S:
        raise ValueError(f"mamba_scan_chunked: {S} steps do not split into "
                         f"{n} chunks of {C} (the reference's chunking)")
    lead = tuple(u.shape[:-2])
    per_chunk = 4 * math.prod(lead) * C * Din * N
    g = max(1, min(n, GROUP_BYTES // per_chunk))

    def chunks(t):
        return t.float().reshape(lead + (n, C, t.shape[-1]))

    uf, df, Bf, Cf = (chunks(t) for t in (u, delta, Bm, Cm))
    Af = _lead(A.float(), len(lead) + 4, 2)                 # (.., 1, 1, Din, N)
    if state is None:
        state = torch.zeros(lead + (Din, N), dtype=torch.float32,
                            device=u.device)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, delta, A, Bm, Cm, state))
    ys = []
    for i in range(0, n, g):
        args = (state, *(t[..., i:i + g, :, :] for t in (uf, df, Bf, Cf)),
                Af)
        if grad:
            state, y = checkpoint(_scan_group, *args, use_reentrant=False)
        else:
            state, y = _scan_group(*args)
        ys.append(y)
    return torch.cat(ys, dim=-2).to(u.dtype), state


def mamba_step(u, delta, A, Bm, Cm, state):
    """Single-token decode. u, delta: (*lead, Din); A: (*alead, Din, N);
    Bm, Cm: (*lead, N); state: (*lead, Din, N) f32."""
    Af = _lead(A.float(), state.dim(), 2)
    df = delta.float()
    da = torch.exp(df[..., None] * Af)
    db = df[..., None] * Bm.float()[..., None, :] * u.float()[..., None]
    h = da * state + db
    y = torch.einsum("...dn,...n->...d", h, Cm.float())
    return y.to(u.dtype), h


def mamba_reference(u, delta, A, Bm, Cm, state=None):
    """Naive sequential oracle (tests only): ``mamba_step`` over the
    sequence."""
    if state is None:
        state = torch.zeros(tuple(u.shape[:-2]) + (u.shape[-1], A.shape[-1]),
                            dtype=torch.float32, device=u.device)
    ys = []
    for t in range(u.shape[-2]):
        y, state = mamba_step(u[..., t, :], delta[..., t, :], A,
                              Bm[..., t, :], Cm[..., t, :], state)
        ys.append(y)
    return torch.stack(ys, dim=-2), state


def causal_conv1d(x, w, b, carry=None):
    """Depthwise causal conv along the sequence. x: (*lead, S, D); w:
    (*wlead, K, D); b: (*wlead, D), ``wlead`` a prefix of ``lead``; carry:
    (*lead, K-1, D), the previous tokens' tail (decode), zeros if None.
    Sums in f32 as the reference. Returns (y (*lead, S, D) in x's dtype,
    the new tail (*lead, K-1, D))."""
    S, D = x.shape[-2:]
    K = w.shape[-2]
    if carry is None:
        carry = x.new_zeros(tuple(x.shape[:-2]) + (K - 1, D))
    xp = torch.cat((carry.to(x.dtype), x), dim=-2)            # (.., S+K-1, D)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        wi = _lead(w[..., i, :].float(), x.dim(), 1)
        y = y + xp[..., i:i + S, :].float() * wi
    y = y + _lead(b.float(), x.dim(), 1)
    return y.to(x.dtype), (xp[..., S:, :] if K > 1 else carry)
