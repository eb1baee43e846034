"""Hand-written Hopper kernels of the port, built from ``csrc/`` sources by
``_build`` on first use."""
from __future__ import annotations

import torch


def guard_grad(name: str, *tensors) -> None:
    """Raise when autograd would record through a kernel launch: a launch
    writes into ``torch.empty`` outputs that carry no ``grad_fn``, so the
    gradient would be dropped without a word. Training goes through the
    ``autograd.Function`` beside each kernel, whose backward is a kernel
    too: ``attention.ops.FlashAttention`` (and ``FlashAttentionPartial``,
    the partial form's, which ring attention's hops take),
    ``reorder.ops.TileSwizzle`` and ``rwkv6.ops.RWKV6Chunked``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and the kernel's output would "
            "carry none; train through the kernel's autograd.Function "
            "(attention.ops.FlashAttention, "
            "attention.ops.FlashAttentionPartial, reorder.ops.TileSwizzle, "
            "rwkv6.ops.RWKV6Chunked), or launch under torch.no_grad()")
