"""Wrapper of the hand-written Hopper reorder kernel (``csrc/reorder.cu``).

Replaces the Pallas TPU kernel ``_copy_kernel`` / ``tile_swizzle_p`` of
``repro.kernels.reorder.reorder`` (PE-assisted reordering, paper §V-A1):
out row-block i = in row-block ``perm[i]`` of a ``(G*b, D)`` array, with
``perm`` an int32 tensor on the device that the kernel reads (the
translation of scalar prefetch). The port's all_to_all runs on it. It is
bounded by the bytes it moves (read once, written once); the kernel's
source note says what its design does about that. ``LAUNCHES`` counts the
launches of this process (set it to 0 before a run to count that run).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, guard_grad

DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_MAX_BLOCKS = 2 ** 31 - 1     # grid.x limit: one destination block per x

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("reorder")
    fn = lib.repro_tile_swizzle
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.repro_reorder_error_string.argtypes = [ctypes.c_int]
        lib.repro_reorder_error_string.restype = ctypes.c_char_p
    return lib


def block_transpose_perm(g1: int, g2: int) -> list[int]:
    """The permutation of ``block_transpose``: block (i, j) of a
    (g1, g2) block grid -> block (j, i)."""
    return [i * g2 + j for j in range(g2) for i in range(g1)]


def _device_perm(perm, x: torch.Tensor) -> torch.Tensor:
    """``perm`` as an int32 tensor on x's device. A host sequence is checked
    for range here; a device tensor is taken as it is (no sync), and an
    entry outside [0, G) then yields a zero block."""
    if isinstance(perm, torch.Tensor) and perm.device == x.device:
        if perm.dtype != torch.int32 or perm.dim() != 1:
            raise TypeError("tile_swizzle: a device perm must be a 1-D int32 "
                            f"tensor, got {perm.dtype} {tuple(perm.shape)}")
        return perm.contiguous()
    host = torch.as_tensor(perm, dtype=torch.int64, device="cpu").reshape(-1)
    if host.numel() and (host.min() < 0 or host.max() >= host.numel()):
        raise ValueError(f"tile_swizzle: perm entries must lie in [0, "
                         f"{host.numel()})")
    return host.to(device=x.device, dtype=torch.int32)


def tile_swizzle(x: torch.Tensor, perm) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor (see ``ref.tile_swizzle`` for the
    function): x (G*b, D) contiguous f32 / bf16 / int32, ``perm`` G entries.
    Raises on anything the kernel does not take, and under grad."""
    global LAUNCHES
    guard_grad("tile_swizzle", x)
    if not x.is_cuda:
        raise ValueError("tile_swizzle: x must be a CUDA tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"tile_swizzle takes {DTYPES}, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"tile_swizzle takes a contiguous (G*b, D) tensor, "
                         f"got {tuple(x.shape)} contiguous="
                         f"{x.is_contiguous()}")
    p = _device_perm(perm, x)
    G = p.numel()
    rows, D = x.shape
    if G < 1 or G > _MAX_BLOCKS or rows % G:
        raise ValueError(f"tile_swizzle: {rows} rows do not split into "
                         f"{G} blocks")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_tile_swizzle(x.data_ptr(), out.data_ptr(),
                                    p.data_ptr(), G,
                                    (rows // G) * D * x.element_size(),
                                    stream)
    if rc != 0:
        msg = lib.repro_reorder_error_string(rc).decode()
        raise RuntimeError(f"tile_swizzle kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES += 1
    return out


def block_transpose(x: torch.Tensor, g1: int, g2: int) -> torch.Tensor:
    """(g1*g2*b, D) block-grid transpose on the kernel: block (i, j) ->
    block (j, i)."""
    return tile_swizzle(x, block_transpose_perm(g1, g2))
