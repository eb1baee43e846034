"""Device dispatch for flash attention: a CUDA tensor launches the Hopper
kernel (``flash.py``) or raises; a CPU tensor takes the plain PyTorch
version (``ref.py``).

``FlashAttention`` is the differentiable form, which training takes: its
forward is the forward kernel asked for the row statistics as well, and
its backward the backward kernel (``flash_bwd.py``); on CPU tensors the
plain versions of both."""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import flash, flash_bwd, ref


def _forward(q):
    return flash.flash_attention if q.is_cuda else ref.flash_attention


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = -1, partial: bool = False,
                    k_scale=None, v_scale=None, lowp: int = 0):
    """``k_scale`` / ``v_scale`` (B, Sk, KV) f32 with int8 k / v: the int8
    KV cache, on the kernel's int8 decode form on CUDA. ``lowp``: the
    low-precision mode (``ref.flash_attention``), which acts on bf16 q
    only; both forms refuse it with the int8 cache."""
    scales = {}
    if k_scale is not None:
        rows = q.shape[1] * (q.shape[2] // k.shape[2])
        if rows > flash.DECODE_ROWS:
            raise ValueError(
                f"flash_attention over an int8 cache takes the decode form "
                f"only (Sq * G <= {flash.DECODE_ROWS} rows a kv head), got "
                f"{rows}: the int8 KV cache exists in decode alone")
        scales = {"k_scale": k_scale, "v_scale": v_scale}
    return _forward(q)(q, k, v, q_pos, k_pos, causal=causal, window=window,
                       partial=partial, lowp=lowp, **scales)


def _backward(q):
    return (flash_bwd.flash_attention_backward if q.is_cuda
            else ref.flash_attention_backward)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` (not partial) with a backward: q (B, Sq, H, hd),
    k / v (B, Sk, KV, hd), int32 positions (B, Sq) / (B, Sk). Saves q, k,
    v, the output and its row statistics (m, l); the backward recomputes
    the scores tile by tile in f32 from those statistics. Under a
    low-precision mode (``lowp``) the forward computes the reference's
    low-precision form and the backward stays in f32: its p = exp(s - m) /
    l lies within bf16's rounding of the forward's."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal: bool, window: int,
                lowp: int = 0):
        out, m, l = _forward(q)(q, k, v, q_pos, k_pos, causal=causal,
                                window=window, stats=True, lowp=lowp)
        ctx.save_for_backward(q, k, v, out, m, l, q_pos, k_pos)
        ctx.mask = (causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l, q_pos, k_pos = ctx.saved_tensors
        causal, window = ctx.mask
        dq, dk, dv = _backward(q)(q, k, v, out, m, l, do.contiguous(), q_pos,
                                  k_pos, causal=causal, window=window)
        return dq, dk, dv, None, None, None, None, None
