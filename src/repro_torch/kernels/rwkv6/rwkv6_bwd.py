"""Wrapper of the hand-written Hopper RWKV6 backward kernel
(``csrc/rwkv6_bwd.cu``).

Replaces no Pallas kernel: the JAX package trains RWKV6 by ``jax.grad`` of
the jnp ``ssm.rwkv6_chunked`` (``src/repro/models/ssm.py:21``). This is
the gradient of the function the forward kernel (``rwkv6.py``) computes,
from the f32 states that kernel saves at each 16-step sub-chunk's start:
one CTA per (batch, head) sweeps the sub-chunks last to first with the
state's gradient carried in shared memory (``ref.rwkv6_chunked_backward``
is the same algorithm in PyTorch). Deterministic: du is summed over the
rows that share a u by a second kernel in row order, not by atomics.
``LAUNCHES`` counts the calls of this process that launched the kernel
(set it to 0 before a run to count that run).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, guard_grad
from repro_torch.kernels.rwkv6 import rwkv6
from repro_torch.kernels.rwkv6.ref import SUB

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rwkv6_bwd")
    fn = lib.repro_rwkv6_backward
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i] + [p] * 15 + [ll, i, i, ll, p]
        fn.restype = i
        lib.repro_rwkv6_backward_error_string.argtypes = [i]
        lib.repro_rwkv6_backward_error_string.restype = ctypes.c_char_p
    return lib


def rwkv6_chunked_backward(r, k, v, logw, u, state, do, dstate=None,
                           states=None):
    """Launch the kernel on CUDA tensors (see
    ``ref.rwkv6_chunked_backward`` for the function). r, k, v, logw, u,
    state: the forward's inputs as ``rwkv6.rwkv6_chunked`` takes them; do:
    (B, S, H, K) in r's dtype; dstate: (B, H, K, K) f32 or None (zeros);
    states: (B, H, ceil(S / 16), K, K) f32, the forward kernel's saved
    states (required). Returns (dr, dk, dv in r's dtype, dlogw f32, du in
    u's dtype, dstate_in f32 or None when no state came in). Raises on
    anything the kernel does not take, and under grad."""
    global LAUNCHES
    guard_grad("rwkv6_chunked_backward", r, k, v, logw, u, state, do,
               dstate)
    rwkv6._check(r, k, v, logw, u, state)
    B, S, H, K = r.shape
    if states is None:
        raise ValueError("rwkv6_chunked_backward: the kernel takes the "
                         "forward kernel's saved states")
    want = (B, H, -(-S // SUB), K, K)
    for name, t, shape, dtype in (
            ("do", do, r.shape, r.dtype), ("states", states, want,
                                           torch.float32),
            ("dstate", dstate, (B, H, K, K), torch.float32)):
        if t is None:
            continue
        if t.device != r.device or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"rwkv6_chunked_backward: {name} must be a contiguous "
                f"{dtype} {tuple(shape)} on {r.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty_like(logw)
    du = torch.empty_like(u)
    du_rows = torch.empty((B, H, K), dtype=torch.float32, device=r.device)
    dstate_in = None if state is None else torch.empty_like(state)
    G = 1 if u.dim() == 2 else u.shape[0]
    lib = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.repro_rwkv6_backward(
            rwkv6._DTYPES[r.dtype], K, *(ptr(t) for t in (
                r, k, v, logw, u, states, do, dstate, dr, dk, dv, dlogw, du,
                du_rows, dstate_in)), B, S, H, G, stream)
    if rc != 0:
        msg = lib.repro_rwkv6_backward_error_string(rc).decode()
        raise RuntimeError(f"rwkv6_chunked_backward kernel launch failed: "
                           f"CUDA error {rc} ({msg})")
    LAUNCHES += 1
    return dr, dk, dv, dlogw, du, dstate_in
