"""Wrapper of the hand-written Hopper flash-attention kernel
(``csrc/flash.cu``).

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``repro.kernels.attention.flash``. On the card it is bounded by the bytes
it moves (the serving shapes attend over a few dozen keys); the kernel's
source note says what its design does about that. ``LAUNCHES`` counts the
launches of this process (set it to 0 before a run to count that run).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_TILES = 65535        # grid.y limit: ceil(Sq * G / 4)

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, q_pos, k_pos):
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and q_pos.device == q.device and k_pos.device == q.device):
        raise ValueError("flash_attention: every tensor must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("flash_attention positions must be int32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,Sq,H,hd), k/v (B,Sk,KV,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if tuple(q_pos.shape) != (B, Sq) or tuple(k_pos.shape) != (B, k.shape[1]):
        raise ValueError("flash_attention: positions must be (B, Sq) and "
                         "(B, Sk)")
    if -(-Sq * (H // k.shape[2]) // 4) > _MAX_ROW_TILES:
        raise ValueError("flash_attention: too many query rows for one grid")
    for t in (q, k, v, q_pos, k_pos):
        if not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous tensors")


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = -1, partial: bool = False):
    """Launch the kernel on CUDA tensors (see ``ref.flash_attention`` for
    the function): q (B, Sq, H, hd), k/v (B, Sk, KV, hd), int32 positions
    (B, Sq)/(B, Sk). Raises on anything the kernel does not take."""
    global LAUNCHES
    _check(q, k, v, q_pos, k_pos)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = acc = m = l = None
    if partial:
        acc = torch.empty((B, H, Sq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    else:
        out = torch.empty_like(q)
    lib = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(), ptr(out), ptr(acc), ptr(m),
            ptr(l), B, Sq, Sk, H, KV, hd, int(causal), int(window),
            hd ** -0.5, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    LAUNCHES += 1
    return (acc, m, l) if partial else out
