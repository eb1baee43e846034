"""Device dispatch for the reorder: a CUDA tensor launches the Hopper kernel
(``reorder.py``) or raises; a CPU tensor takes the plain PyTorch version
(``ref.py``)."""
from __future__ import annotations

from repro_torch.kernels.reorder import ref, reorder


def tile_swizzle(x, perm):
    fn = reorder.tile_swizzle if x.is_cuda else ref.tile_swizzle
    return fn(x, perm)
