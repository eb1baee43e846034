"""Device dispatch for flash attention: a CUDA tensor launches the Hopper
kernel (``flash.py``) or raises; a CPU tensor takes the plain PyTorch
version (``ref.py``)."""
from __future__ import annotations

from repro_torch.kernels.attention import flash, ref


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = -1, partial: bool = False):
    fn = flash.flash_attention if q.is_cuda else ref.flash_attention
    return fn(q, k, v, q_pos, k_pos, causal=causal, window=window,
              partial=partial)
