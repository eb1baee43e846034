"""Wrapper of the hand-written Hopper RWKV6 backward kernels
(``csrc/rwkv6_bwd.cu``).

Replaces no Pallas kernel: the JAX package trains RWKV6 by ``jax.grad`` of
the jnp ``ssm.rwkv6_chunked`` (``src/repro/models/ssm.py:21``). This is
the gradient of the function the forward kernel (``rwkv6.py``) computes,
from the f32 states that kernel saves every 64 steps, in two passes on
tensor cores (``ref.rwkv6_chunked_backward`` is the same algorithm in
PyTorch): pass 1 carries only the state's gradient, last 16-step
sub-chunk to first, and writes it at each 64-step chunk's end; pass 2
takes each (batch, head, 64-step chunk) on its own CTA from the state
saved at its start and that gradient. Deterministic: du is summed over
the chunks and the rows that share a u by a third kernel in a fixed
order, not by atomics. ``LAUNCHES`` counts the calls of this process that
launched the kernels, one per call (set it to 0 before a run to count
that run).

What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``,
bf16, rwkv6-7b's training shapes (4, 1024, 64, 64) and (32, 1024, 8,
64)): 0.61-0.62 ms a call against a bytes bound of 0.110 ms (one CTA per
(batch, head) on CUDA cores took 1.855). Pass 1 (0.107 ms) is bound by
its loads: a warp owns 16 key channels by all 64 value columns, so the
chain costs a few mma a sub-chunk and no barrier, and do is read once
per 16 channels
(``tools/rwkv6_bwd_state_cols.py``: 16 columns a warp took 0.184 ms).
Pass 2 (0.49-0.50 ms) is bound by instruction issue and latency at two
CTAs of four warps an SM: 4,096 CTAs fill the card, its products run on
mma.sync with every f32 operand in three bf16 pieces, two barriers a
sub-chunk. ptxas, K = 64: pass 2 252 / 242 registers (bf16 / f32) and
102.7 / 111.9 KB of shared memory, pass 1 136 / 167 registers and none;
no spill at any K (the source's header has every instance).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, guard_grad
from repro_torch.kernels.rwkv6 import rwkv6
from repro_torch.kernels.rwkv6.ref import SAVE

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rwkv6_bwd")
    fn = lib.repro_rwkv6_backward
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i] + [p] * 16 + [ll, i, i, ll, p]
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
    states: (B, H, ceil(S / 64), K, K) f32, the forward kernel's saved
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
    n_save = -(-S // SAVE)
    want = (B, H, n_save, K, K)
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
    # pair loads of do, u and the f32 states
    for name, t in (("do", do), ("u", u), ("states", states),
                    ("dstate", dstate)):
        if t is not None and t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"rwkv6_chunked_backward: {name} must start on "
                             f"a 2-element boundary")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty_like(logw)
    du = torch.empty_like(u)
    ends = torch.empty_like(states)       # pass 1's gradients at chunk ends
    du_parts = torch.empty((B, H, n_save, K), dtype=torch.float32,
                           device=r.device)
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
                ends, du_parts, dstate_in)), B, S, H, G, stream)
    if rc != 0:
        msg = lib.repro_rwkv6_backward_error_string(rc).decode()
        raise RuntimeError(f"rwkv6_chunked_backward kernel launch failed: "
                           f"CUDA error {rc} ({msg})")
    LAUNCHES += 1
    return dr, dk, dv, dlogw, du, dstate_in
