"""Plain PyTorch version of the reorder kernel (``reorder.py``).

The same function as the CUDA kernel -- and as the JAX package's
``kernels/reorder/ref.py`` / Pallas ``_copy_kernel``: one ``index_select``
over the ``(G, b*D)`` view. The CPU path of ``ops.tile_swizzle`` and the
kernel's yardstick on the card.
"""
from __future__ import annotations

import torch


def tile_swizzle(x: torch.Tensor, perm) -> torch.Tensor:
    """x: (G*b, D); perm: G block indices. Out block i = in block perm[i]."""
    perm = torch.as_tensor(perm, device=x.device).reshape(-1).long()
    G = perm.numel()
    rows, D = x.shape
    if rows % G:
        raise ValueError(f"tile_swizzle: {rows} rows do not split into "
                         f"{G} blocks")
    return torch.index_select(x.reshape(G, -1), 0, perm).reshape(rows, D)


def block_transpose(x: torch.Tensor, g1: int, g2: int) -> torch.Tensor:
    """(g1*g2*b, D) block-grid transpose: block (i, j) -> block (j, i)."""
    rows, D = x.shape
    b = rows // (g1 * g2)
    return x.reshape(g1, g2, b, D).transpose(0, 1).reshape(rows, D)
