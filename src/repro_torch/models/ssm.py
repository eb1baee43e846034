"""Sequence-mixing recurrences: RWKV6 ("Finch", data-dependent decay linear
attention with a per-head matrix state).

The counterpart of ``repro.models.ssm`` (the RWKV6 part; Mamba waits for
its slice). ``rwkv6_chunked`` runs the chunked form on the hand-written
Hopper kernel for CUDA tensors and on its plain PyTorch version for CPU
tensors (``repro_torch.kernels.rwkv6.ops``); leading axes (the cube's PEs
and the batch) fold into the kernel's batch, so a layer is one launch.
Under autograd it goes through ``ops.RWKV6Chunked``, whose backward is the
RWKV6 backward kernel.
Decode takes the one-token ``rwkv6_step``, plain math as in the JAX
package.
"""
from __future__ import annotations

import math

import torch

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
