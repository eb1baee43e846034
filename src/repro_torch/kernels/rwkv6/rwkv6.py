"""Wrapper of the hand-written Hopper RWKV6 kernel (``csrc/rwkv6.cu``).

Replaces the Pallas TPU kernel ``_rwkv_kernel`` / ``rwkv6_chunked`` of
``repro.kernels.rwkv6.rwkv6`` and computes the function of the JAX
package's ``ssm.rwkv6_chunked``: the RWKV6 time-mix recurrence with a state
in and out (see ``ref.rwkv6_chunked``). One launch covers every (batch,
head) of a call, so the model folds the cube's PEs into the batch and runs
one launch per layer: one CTA of K / 16 warps per (batch, head), the
state in registers, the products on tensor cores with every f32 operand
split into three bf16 pieces, so the arithmetic stays f32 in both input
types.

What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``):
the latency of each sub-chunk's chain of dependent mma. At the serving
shapes (4, 48 or 32, 64, 64) in bf16 a forward takes 0.0129 ms and a
prefill 0.0094, 3.0-3.2x the bytes bound (0.0041 / 0.0031 ms), where the
previous design took 0.0484 / 0.0334 ms; (4, 512, 64, 64) takes 0.106 ms
in bf16 (3.2x the bytes bound) and 0.107 in f32 (1.7x the operations
bound). ``LAUNCHES`` counts the launches of this process (set it to
0 before a run to count that run).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, guard_grad
from repro_torch.kernels.rwkv6.ref import SAVE

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CTAS = 2 ** 31 - 1       # grid.x limit: one CTA per (batch, head)

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rwkv6")
    fn = lib.repro_rwkv6_chunked
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, ll, i, i, ll, p]
        fn.restype = i
        lib.repro_rwkv6_error_string.argtypes = [i]
        lib.repro_rwkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, logw, u, state):
    tensors = [r, k, v, logw, u] + ([] if state is None else [state])
    if not (r.is_cuda and all(t.device == r.device for t in tensors)):
        raise ValueError("rwkv6_chunked: every tensor must be on one CUDA "
                         "device")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, u)):
        raise TypeError(f"rwkv6_chunked takes f32 or bf16 r/k/v/u of one "
                        f"dtype, got {r.dtype}/{k.dtype}/{v.dtype}/{u.dtype}")
    if logw.dtype != torch.float32 or (state is not None
                                       and state.dtype != torch.float32):
        raise TypeError("rwkv6_chunked: logw and the state must be f32")
    if r.dim() != 4 or k.shape != r.shape or logw.shape != r.shape \
            or v.shape != r.shape:
        raise ValueError(f"rwkv6_chunked: r, k, v, logw (B, S, H, K) with "
                         f"V == K; got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}")
    B, S, H, K = r.shape
    if K not in HEAD_DIMS:
        raise ValueError(f"rwkv6_chunked kernel takes K in {HEAD_DIMS}, "
                         f"got {K}")
    if S < 1 or B < 1 or B * H > _MAX_CTAS:
        raise ValueError(f"rwkv6_chunked: no grid for B={B}, S={S}, H={H}")
    if u.dim() not in (2, 3) or tuple(u.shape[-2:]) != (H, K) \
            or (u.dim() == 3 and B % u.shape[0]):
        raise ValueError(f"rwkv6_chunked: u must be (H, K) or (G, H, K) "
                         f"with G dividing B={B}; got {tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (B, H, K, K):
        raise ValueError(f"rwkv6_chunked: state must be {(B, H, K, K)}, got "
                         f"{tuple(state.shape)}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("rwkv6_chunked takes contiguous tensors")
    # 4-element vector loads of r, k, v and logw
    for t in (r, k, v, logw):
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError("rwkv6_chunked: r, k, v and logw must start on "
                             "a 4-element boundary")


def rwkv6_chunked(r, k, v, logw, u, state=None, *, states: bool = False):
    """Launch the kernel on CUDA tensors (see ``ref.rwkv6_chunked`` for the
    function; the kernel takes any length S). r, k, v: (B, S, H, K) f32 or
    bf16; logw: (B, S, H, K) f32; u: (H, K) or (G, H, K) in r's dtype;
    state: (B, H, K, K) f32 or None. Returns (o in r's dtype, final state
    f32), and with ``states`` also the f32 state at the start of each
    64-step chunk, (B, H, ceil(S / 64), K, K) (``ref.chunk_states``),
    which the backward kernel takes. Raises on anything the kernel does
    not take, and under grad."""
    global LAUNCHES
    guard_grad("rwkv6_chunked", r, k, v, logw, u, state)
    _check(r, k, v, logw, u, state)
    B, S, H, K = r.shape
    o = torch.empty_like(r)
    state_out = torch.empty((B, H, K, K), dtype=torch.float32,
                            device=r.device)
    G = 1 if u.dim() == 2 else u.shape[0]
    saved = (torch.empty((B, H, -(-S // SAVE), K, K), dtype=torch.float32,
                         device=r.device) if states else None)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.repro_rwkv6_chunked(
            _DTYPES[r.dtype], K, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            logw.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), o.data_ptr(),
            state_out.data_ptr(), None if saved is None else saved.data_ptr(),
            B, S, H, G, stream)
    if rc != 0:
        msg = lib.repro_rwkv6_error_string(rc).decode()
        raise RuntimeError(f"rwkv6_chunked kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES += 1
    return (o, state_out, saved) if states else (o, state_out)
