"""Ring attention: sequence-parallel flash attention over a communicator.

The counterpart of ``repro.kernels.collective.attention``. Each PE keeps
its query block resident and rotates its (k, v) block around the group's
ring through the registered ``ring_fused`` all_gather flow; every hop runs
the flash kernel's partial form (``layers.chunked_attention(...,
partial=True)``, the cube's axes folded into its batch) with that PE's
query positions and the delivered block's key positions, and the per-hop
``(acc, m, l)`` partials merge online-softmax style. The full-sequence k/v
never materializes on any PE.

A hop whose keys all lie ahead of a PE's queries (causal) is wholly
masked: the kernel's contract gives such a row ``m = -1e30`` and ``l = Sk``
(the mean of v), and the merge weighs it by ``exp(-1e30 - m) = 0`` once a
visible hop has set ``m`` -- hop 0 is the PE's own block, whose diagonal
every causal or windowed row sees.

It trains: under grad each hop's partial form is
``ops.FlashAttentionPartial`` (through ``chunked_attention``), whose
backward is one launch of the backward kernel's partial form a hop, with
the hop's m held fixed -- exact here, since the merge depends on each hop's
(acc, m, l) only through ``acc e^m`` and ``l e^m``. Autograd carries dk and
dv back through the ring's rolls (``dispatch_fused``), so the backward of
a ring of g members costs g partial backward launches and the rolls'
transposes, and, as the forward, never gathers the sequence.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.collective.ring import dispatch_fused
from repro_torch.models import layers
from repro_torch.models.layers import NEG_INF, chunked_attention

__all__ = ["RING_ATTN_TOL", "ring_attention"]

# accuracy budget against the gather-then-attend oracle: merging per-hop
# partials reorders the exp / sum of the single-pass softmax
RING_ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def ring_attention(comm, q, k, v, *, causal: bool = True, window: int = -1):
    """Sequence-parallel attention over ``comm``'s ring.

    q: (*cube, B, S_loc, H, hd) -- each PE's query block; k, v:
    (*cube, B, S_loc, KV, hd) -- each PE's key/value block. The global
    sequence is the concatenation of the members' blocks in group order,
    so member r's positions are ``r * S_loc + arange(S_loc)``.

    Returns (*cube, B, S_loc, H, hd) in q's dtype: each PE's rows of the
    full-sequence attention, within ``RING_ATTN_TOL[dtype]`` of it."""
    S_loc = q.shape[-3]
    if comm.group_size == 1:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 lowp=layers.LOWP)
    q_off = (comm.axis_index(q.device) * S_loc)[..., None]   # (*cube, 1)

    def consume(state, src, kv_block):
        kb, vb = kv_block
        acc, m, l = state
        acc_h, m_h, l_h = chunked_attention(
            q, kb, vb, causal=causal, window=window, q_offset=q_off,
            k_offset=(src * S_loc)[..., None], partial=True,
            lowp=layers.LOWP)
        m_new = torch.maximum(m, m_h)
        c = torch.exp(m - m_new)
        c_h = torch.exp(m_h - m_new)
        return (acc * c[..., None] + acc_h * c_h[..., None], m_new,
                l * c + l_h * c_h)

    lead = tuple(q.shape[:-3])
    H, hd = q.shape[-2], q.shape[-1]
    init = (torch.zeros(lead + (H, S_loc, hd), dtype=torch.float32,
                        device=q.device),
            torch.full(lead + (H, S_loc), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros(lead + (H, S_loc), dtype=torch.float32,
                        device=q.device))
    acc, m, l = dispatch_fused(comm, "all_gather", "ring_fused", (k, v),
                               axis=1, consume_fn=consume, init=init)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(-3, -2).to(q.dtype)
