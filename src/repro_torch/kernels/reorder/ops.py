"""Device dispatch for the reorder: a CUDA tensor launches the Hopper kernel
(``reorder.py``) or raises; a CPU tensor takes the plain PyTorch version
(``ref.py``).

``tile_swizzle(x, perm, inv)`` is the one entry point. Where autograd
records it goes through ``TileSwizzle``, whose forward is the reorder by
``perm`` and whose backward the reorder of dy by ``inv``, the inverse
permutation: the same kernel on the card. Elsewhere it is the plain
dispatch."""
from __future__ import annotations

import torch

from repro_torch.kernels.reorder import ref, reorder


def _dispatch(x, perm):
    fn = reorder.tile_swizzle if x.is_cuda else ref.tile_swizzle
    return fn(x, perm)


def inverse_perm(perm) -> torch.Tensor | None:
    """The inverse of a host permutation (``argsort``), as int64 on the
    CPU, or None when ``perm`` is not a bijection of [0, G)."""
    host = torch.as_tensor(perm, device="cpu").reshape(-1).long()
    G = host.numel()
    if not torch.equal(torch.sort(host).values, torch.arange(G)):
        return None
    return torch.argsort(host)


class TileSwizzle(torch.autograd.Function):
    """The reorder with a backward: out block i = in block perm[i], so dx
    block perm[i] = dy block i, i.e. dx = reorder(dy, inv). ``inv`` is the
    inverse permutation on x's device (``Communicator.block_perm`` caches
    it beside the perm, so the backward does not sync the host), or None
    where perm is not a bijection: then there is no such backward, and
    the Function raises under grad."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        if ctx.needs_input_grad[0] and inv is None:
            raise ValueError(
                "TileSwizzle: no inverse permutation (perm is not a "
                "bijection), so the reorder has no gradient of this form")
        ctx.inv = inv
        return _dispatch(x, perm)

    @staticmethod
    def backward(ctx, dy):
        return _dispatch(dy.contiguous(), ctx.inv), None, None


def tile_swizzle(x, perm, inv=None):
    """Out row-block i = x's row-block ``perm[i]``. Through ``TileSwizzle``
    where autograd records and x requires a gradient (``inv``, the inverse
    permutation, is then needed), else the plain dispatch."""
    if torch.is_grad_enabled() and x.requires_grad:
        return TileSwizzle.apply(x, perm, inv)
    return _dispatch(x, perm)
