"""Wrapper of the hand-written Hopper reorder kernel (``csrc/reorder.cu``).

Replaces the Pallas TPU kernel ``_copy_kernel`` / ``tile_swizzle_p`` of
``repro.kernels.reorder.reorder`` (PE-assisted reordering, paper §V-A1):
out row-block i = in row-block ``perm[i]`` of a ``(G*b, D)`` array, with
``perm`` an int32 tensor on the device that the kernel reads (the
translation of scalar prefetch). The port's all_to_all runs on it. It is
bounded by the bytes it moves (read once, written once); the kernel's
source note says what its design does about that. ``plan`` computes the
launch geometry, which the C entry point checks; the CPU tests reach it.
``LAUNCHES`` counts the launches of this process (set it to 0 before a run
to count that run).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, guard_grad

DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_MAX_BLOCKS = 2 ** 31 - 1     # perm is int32: a block index must fit
WIDTHS = (16, 8, 4, 2)        # word sizes in bytes, widest first
THREADS = 256                 # a CTA; one word a thread
MAX_GRID = 2 ** 31 - 1        # grid.x
MAX_WORDS_32 = 2 ** 31 - 1    # payloads up to this many words: 32-bit indices


class Plan(NamedTuple):
    """The launch geometry of one reorder: ``width`` the word in bytes,
    ``block_words`` a block's words, ``index_bits`` 32 or 64, ``threads``
    a CTA, ``grid`` CTAs, and the 32-bit index's divisor of
    ``block_words`` (``mul``, ``shr``; 0 on 64 bits)."""
    width: int
    block_words: int
    index_bits: int
    threads: int
    grid: int
    mul: int
    shr: int


def magic(d: int) -> tuple[int, int]:
    """The 31-bit magic divisor of d >= 1 (the kernel's ``magic``): for
    every n < 2^31, n // d == (n if d == 1 else ((n * mul) >> 32) >> shr),
    with l = ceil(log2 d), mul = ceil(2^(31 + l) / d) < 2^32, shr = l - 1.
    Exact because mul * d - 2^(31 + l) < d and n * d < 2^(31 + l)."""
    if d < 1 or d > MAX_WORDS_32:
        raise ValueError(f"magic: divisor {d} outside [1, 2^31)")
    if d == 1:
        return 0, 0
    lg = (d - 1).bit_length()
    return -(-(1 << (31 + lg)) // d), lg - 1


def word_width(block_bytes: int, align: int) -> int:
    """The widest word (16, 8, 4 or 2 bytes) dividing both the pointers'
    alignment and the block size."""
    w = next((w for w in WIDTHS if align % w == 0 and block_bytes % w == 0),
             None)
    if w is None:
        raise ValueError(f"tile_swizzle: a block of {block_bytes} bytes at "
                         f"{align}-byte alignment has no 2-byte word")
    return w


@functools.lru_cache(maxsize=512)
def plan(G: int, block_bytes: int, align: int) -> Plan:
    """The launch geometry of a reorder of G blocks of ``block_bytes``
    bytes whose pointers are ``align``-byte aligned (16 at most counts):
    threads over the flat output words, one word a thread, so one CTA per
    THREADS words (at most MAX_GRID, the kernel striding past it); 32-bit
    indices with the magic divisor up to MAX_WORDS_32 words, 64-bit
    above."""
    if G < 1 or G > _MAX_BLOCKS or block_bytes < 1:
        raise ValueError(f"tile_swizzle: no plan for G={G}, "
                         f"block_bytes={block_bytes}")
    width = word_width(block_bytes, align)
    bw = block_bytes // width
    n = G * bw
    bits = 32 if n <= MAX_WORDS_32 else 64
    mul, shr = magic(bw) if bits == 32 else (0, 0)
    return Plan(width, bw, bits, THREADS, min(-(-n // THREADS), MAX_GRID),
                mul, shr)


def _align(*ptrs: int) -> int:
    """The largest power of two up to 16 dividing every pointer."""
    a = 0
    for p in ptrs:
        a |= p
    return next((w for w in WIDTHS if a % w == 0), 1)


LAUNCHES = 0
LAST_PLAN: Plan | None = None   # the geometry of this process's last launch


def _lib() -> ctypes.CDLL:
    lib = _build.load("reorder")
    fn = lib.repro_tile_swizzle
    if fn.argtypes is None:
        p, ll, i, u = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_uint)
        # x, out, perm, G, block_bytes, width, index_bits, threads, grid,
        # mul, shr, stream
        fn.argtypes = [p, p, p, ll, ll, i, i, i, ll, u, u, p]
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
    function): x (G*b, D) contiguous f32 / bf16 / int32, ``perm`` G entries,
    on the geometry of ``plan`` (kept in ``LAST_PLAN``). Raises on anything
    the kernel does not take, and under grad."""
    global LAUNCHES, LAST_PLAN
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
    block_bytes = (rows // G) * D * x.element_size()
    g = plan(G, block_bytes, _align(x.data_ptr(), out.data_ptr()))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_tile_swizzle(x.data_ptr(), out.data_ptr(),
                                    p.data_ptr(), G, block_bytes, g.width,
                                    g.index_bits, g.threads, g.grid, g.mul,
                                    g.shr, stream)
    if rc != 0:
        msg = lib.repro_reorder_error_string(rc).decode()
        raise RuntimeError(f"tile_swizzle kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES += 1
    LAST_PLAN = g
    return out


def block_transpose(x: torch.Tensor, g1: int, g2: int) -> torch.Tensor:
    """(g1*g2*b, D) block-grid transpose on the kernel: block (i, j) ->
    block (j, i)."""
    return tile_swizzle(x, block_transpose_perm(g1, g2))
