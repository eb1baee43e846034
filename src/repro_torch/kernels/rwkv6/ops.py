"""Device dispatch for the RWKV6 recurrence: a CUDA tensor launches the
Hopper kernel (``rwkv6.py``) or raises; a CPU tensor takes the plain
PyTorch version (``ref.py``), which keeps the chunk rule of
``ssm.rwkv6_chunked``. The kernel takes any length: it picks its own
sub-chunk.

``rwkv6_chunked`` is the one entry point. Where autograd records it goes
through ``RWKV6Chunked``, the differentiable form: its forward is the
forward kernel asked for the state at each 64-step chunk's start as well, and
its backward the backward kernel (``rwkv6_bwd.py``); on CPU tensors the
plain versions of both. Elsewhere it is the plain dispatch: a serving
launch saves no states."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import ref, rwkv6, rwkv6_bwd


def _dispatch(r, k, v, logw, u, state=None):
    if r.is_cuda:
        return rwkv6.rwkv6_chunked(r, k, v, logw, u, state)
    return ref.rwkv6_chunked(r, k, v, logw, u, state)


def _forward(r):
    """(o, final state, saved states) of the forward."""
    if r.is_cuda:
        return lambda *a: rwkv6.rwkv6_chunked(*a, states=True)

    def plain(r, k, v, logw, u, state):
        o, s = ref.rwkv6_chunked(r, k, v, logw, u, state)
        return o, s, ref.chunk_states(k, v, logw, state)
    return plain


def _backward(r):
    return (rwkv6_bwd.rwkv6_chunked_backward if r.is_cuda
            else ref.rwkv6_chunked_backward)


class RWKV6Chunked(torch.autograd.Function):
    """``rwkv6_chunked`` with a backward: r, k, v (B, S, H, K), logw f32,
    u (H, K) or (G, H, K), state (B, H, K, K) f32 or None; returns (o,
    final state). Saves the inputs and the f32 state at the start of each
    64-step chunk, (B, H, ceil(S / 64), K, K); the backward takes each
    chunk from the state saved at its start and the gradient at its end."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state):
        o, s_out, states = _forward(r)(r, k, v, logw, u, state)
        ctx.save_for_backward(r, k, v, logw, u, state, states)
        ctx.set_materialize_grads(False)
        return o, s_out

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, logw, u, state, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        dr, dk, dv, dlogw, du, dstate_in = _backward(r)(
            r, k, v, logw, u, state, do.to(r.dtype).contiguous(),
            None if dstate is None else dstate.float().contiguous(),
            states)
        return dr, dk, dv, dlogw, du, dstate_in


def rwkv6_chunked(r, k, v, logw, u, state=None):
    """(o, final state) of the recurrence. Through ``RWKV6Chunked`` where
    autograd records and an input requires a gradient (gradients then
    flow to every input that requires one), else the plain dispatch."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, logw, u, state)):
        return RWKV6Chunked.apply(r, k, v, logw, u, state)
    return _dispatch(r, k, v, logw, u, state)
