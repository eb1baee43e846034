"""8-bit cross-domain modulation for the slow (DCN) hop (PID-Comm §V-C).

The counterpart of ``repro.core.compress``. Quantizing the payload to int8
before it crosses the pod (DCN) boundary shrinks the slow-domain bytes by
the payload's width over one byte (plus one f32 scale per block), and error
feedback keeps the optimizer contract. On the in-process cube the hops are
data movements over the cube tensor's leading axes: the ICI reduce-scatter
and all-gather are the direct bodies of ``repro_torch.core.comm``, and the
DCN hop gathers every pod's int8 shard and its scales and sums their
dequantized values in pod order.
"""
from __future__ import annotations

import torch

from repro_torch.core.hypercube import Hypercube


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax int8 quantization of ``x`` flattened (zero-padded to
    a whole block). Returns (q (n_blocks, block) int8, scales (n_blocks, 1)
    f32). ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    size: int) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:size].reshape(shape)


def compressed_pod_all_reduce(x: torch.Tensor, cube: Hypercube, fast_dims,
                              slow_dims, *, block: int = 256
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical all-reduce of the cube tensor ``x`` with an int8 DCN hop
    and error feedback. ICI: full-precision reduce-scatter. DCN: int8
    all-gather of the 1/|ICI| shard and a local dequantize-and-sum. ICI:
    all-gather back.

    Returns (all_reduced, local_quantization_error) -- callers add the error
    into the next step's payload (error feedback)."""
    fast = cube.resolve_dims(fast_dims) if fast_dims else ()
    slow = cube.resolve_dims(slow_dims)
    return _compressed_hops(x, cube, fast, slow, block)


def compressed_all_reduce(x: torch.Tensor, cube: Hypercube, dims, *,
                          block: int = 256) -> torch.Tensor:
    """§V-C compressed all-reduce under an autograd boundary.

    Forward: the hierarchical all-reduce over ``dims`` with the DCN hop in
    blockwise-absmax int8 (the local quantization error is dropped; callers
    that keep error feedback call :func:`compressed_pod_all_reduce`).
    Backward: the cotangent takes the same compressed all-reduce -- the
    reference's straight-through ``custom_vjp``."""
    fast, slow = cube.split_fast_slow(dims)
    if not slow:
        raise ValueError(f"{dims} never crosses DCN; use a plain all-reduce")
    return _CompressedAllReduce.apply(x, cube, fast, slow, block)


class _CompressedAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cube, fast, slow, block):
        ctx.args = (cube, fast, slow, block)
        return _compressed_hops(x, cube, fast, slow, block)[0]

    @staticmethod
    def backward(ctx, ct):
        cube, fast, slow, block = ctx.args
        return (_compressed_hops(ct, cube, fast, slow, block)[0], None, None,
                None, None)


def _compressed_hops(x, cube: Hypercube, fast, slow, block: int):
    from repro_torch.core import comm as C
    c = cube.ndim
    lead = tuple(x.shape[:c])
    ici = C.Communicator(cube, fast) if fast else None
    dcn = C.Communicator(cube, slow)
    gf = ici.group_size if ici else 1
    flat = x.reshape(lead + (-1,))
    size = flat.shape[-1]
    pad = (-size) % (gf * block)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    shard = C._rs_direct(ici, flat, axis=0, op="add") if ici else flat
    n = shard.shape[-1]
    # every PE's shard is a whole number of blocks, so one quantization of
    # the cube tensor is each PE's own
    q, scale = quantize_int8(shard, block)
    q = q.reshape(lead + (n // block, block))
    scale = scale.reshape(lead + (n // block, 1))
    deq = (q.to(torch.float32) * scale).reshape(lead + (n,))
    err_shard = shard - deq
    # DCN hop: each pod's int8 shard and scales reach every pod, which
    # dequantizes and sums them in pod order
    q_all = dcn.group_view(q)                       # (G_slow, *inst, nb, B)
    s_all = dcn.group_view(scale)
    summed = (q_all.to(torch.float32) * s_all).sum(0).reshape(
        q_all.shape[1:-2] + (n,))
    summed = C._to_members(dcn, summed)
    if ici:
        full = C._ag_direct(ici, summed, axis=0)
        err = C._ag_direct(ici, err_shard, axis=0)
    else:
        full, err = summed, err_shard
    if pad:
        full, err = full[..., :size], err[..., :size]
    return full.reshape(x.shape).to(x.dtype), err.reshape(x.shape)


__all__ = ["compressed_all_reduce", "compressed_pod_all_reduce",
           "dequantize_int8", "quantize_int8"]
