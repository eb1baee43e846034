"""Wrapper of the hand-written Hopper flash-attention backward
(``csrc/flash_bwd.cu``).

The JAX package has no Pallas backward: its train step differentiates the
jnp ``chunked_attention`` (``repro.models.layers``), so this kernel
replaces no TPU kernel; it is the backward of ``flash.py``'s forward, and
``ref.flash_attention_backward`` is its plain version. One call is one
count in ``LAUNCHES`` (the call issues the dq pass and the dk / dv pass on
the current stream). Head dim 128 only, f32 and bf16.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, guard_grad
from repro_torch.kernels.attention.flash import _DTYPES

HEAD_DIMS = (128,)
LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    fn = lib.repro_flash_attention_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 13 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = i
        lib.repro_flash_bwd_error_string.argtypes = [i]
        lib.repro_flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_layout(q, k, v, o, m, l, do, q_pos, k_pos) -> None:
    """Types, shapes and contiguity the kernel takes, on any device."""
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, do)):
        raise TypeError("flash_attention_backward takes f32 or bf16 q/k/v/o/"
                        "do of one dtype")
    if m.dtype != torch.float32 or l.dtype != torch.float32:
        raise TypeError("flash_attention_backward: m and l must be f32")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("flash_attention_backward: positions must be int32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_backward: q (B,Sq,H,hd), k/v "
                         "(B,Sk,KV,hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention_backward: incompatible q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_backward kernel takes head_dim "
                         f"in {HEAD_DIMS}, got {hd}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_backward: o and do must be q's "
                         "shape")
    if tuple(m.shape) != (B, H, Sq) or tuple(l.shape) != (B, H, Sq):
        raise ValueError("flash_attention_backward: m and l must be "
                         "(B, H, Sq)")
    if tuple(q_pos.shape) != (B, Sq) or tuple(k_pos.shape) != (B, Sk):
        raise ValueError("flash_attention_backward: positions must be "
                         "(B, Sq) and (B, Sk)")
    for t in (q, k, v, o, m, l, do, q_pos, k_pos):
        if not t.is_contiguous():
            raise ValueError("flash_attention_backward takes contiguous "
                             "tensors")


def flash_attention_backward(q, k, v, o, m, l, do, q_pos, k_pos, *,
                             causal: bool = True, window: int = -1):
    """Launch the backward on CUDA tensors (see
    ``ref.flash_attention_backward`` for the function). Returns
    ``(dq, dk, dv)`` in the inputs' dtype. Deterministic: two calls on the
    same inputs give the same bits."""
    global LAUNCHES
    guard_grad("flash_attention_backward", q, k, v, o, do)
    tensors = (q, k, v, o, m, l, do, q_pos, k_pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_attention_backward: every tensor must be on "
                         "one CUDA device")
    check_layout(*tensors)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention_backward(
            _DTYPES[q.dtype],
            *(t.data_ptr() for t in (q, k, v, o, do, m, l, q_pos, k_pos)),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, Sq, Sk, H, KV, hd, int(causal), int(window), hd ** -0.5,
            stream)
    if rc != 0:
        msg = lib.repro_flash_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_backward kernel launch failed: "
                           f"CUDA error {rc} ({msg})")
    LAUNCHES += 1
    return dq, dk, dv
