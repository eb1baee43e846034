"""Device dispatch for the RWKV6 recurrence: a CUDA tensor launches the
Hopper kernel (``rwkv6.py``) or raises; a CPU tensor takes the plain
PyTorch version (``ref.py``), which keeps the chunk rule of
``ssm.rwkv6_chunked``. The kernel takes any length: it picks its own
sub-chunk."""
from __future__ import annotations

from repro_torch.kernels.rwkv6 import ref, rwkv6


def rwkv6_chunked(r, k, v, logw, u, state=None):
    if r.is_cuda:
        return rwkv6.rwkv6_chunked(r, k, v, logw, u, state)
    return ref.rwkv6_chunked(r, k, v, logw, u, state)
