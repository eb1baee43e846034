"""Wrapper of the hand-written Hopper flash-attention kernel
(``csrc/flash.cu``).

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``repro.kernels.attention.flash``. Two forms, one launch each:
``launch_geometry`` picks the form and the grid from the shapes (a pure
function, so the CPU tests can check it); the kernel's source note says
what bounds each form and what its design does about it. ``LAUNCHES``
counts the launches of this process (set it to 0 before a run to count
that run).

The int8 KV cache goes through the same entry point: ``flash_attention(
..., k_scale=, v_scale=)`` with int8 k / v launches the decode form's int8
instances (``repro_flash_decode_int8``), which read the codes and the f32
scales directly; those launches count in ``INT8_LAUNCHES``, not in
``LAUNCHES``.

The low-precision modes (``lowp`` 1 / 2, the reference's ``LOWP``) are a
run-time argument of the bf16 forms, decode and forward: a launch under a
mode counts in ``LAUNCHES`` and in ``LOWP_LAUNCHES[mode]``. f32 q runs mode
0 whatever is asked (the reference's function on f32 q), and the int8
cache refuses a mode.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, guard_grad

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_MAX_ROW_TILES = 65535        # grid.y limit: the forward's row tiles
_MAX_CTAS_X = 2 ** 31 - 1     # grid.x limit: B * KV
SMS = 132                     # H100 SXM streaming multiprocessors
DECODE_ROWS = 8               # decode form: Sq * G rows at most
DECODE_WARPS = 8
MAX_SPLITS = 8                # keys of one (batch, kv head) over a cluster
MIN_SPLIT_KEYS = 256          # fewest keys worth a CTA of their own
SPLIT_TARGET_CTAS = 2 * SMS   # a split cache aims at two CTAs per SM
FORWARD_KEY_TILE = {torch.bfloat16: 64, torch.float32: 32}
F32_ROW_TILE = 32             # 8 warps x 4 rows


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch: ``grid`` = (B * KV, y) CTAs of ``block`` threads. CTA
    (x, y) serves batch x // KV, kv head x % KV. Decode form: y is the key
    split, the CTA takes every query row (``row_tile`` = Sq * G) and keys
    [y * keys_per_split, (y + 1) * keys_per_split); the ``key_splits`` CTAs
    of one (batch, kv head) form a cluster. Forward form: y is the row
    tile, the CTA takes query rows [y * row_tile, (y + 1) * row_tile) and
    every key, ``key_tile`` at a time. A query row is (position, group
    member): row r is position r // G of query head kv_head * G + r % G."""
    form: str                 # "decode" or "forward"
    grid: tuple[int, int]
    block: int
    row_tile: int
    key_splits: int
    keys_per_split: int
    key_tile: int             # forward: keys per shared tile; decode: keys
    #                           per warp step (lane groups x warps)


def decode_lanes(hd: int, dtype: torch.dtype) -> int:
    """Lanes of the decode form's group that holds one key of ``dtype``
    (the K/V type): the key's 16-byte pieces rounded up to a power of two,
    at least 2 and at most a warp (hd 96 pads its 12 bf16 / 24 f32 / 6
    int8 pieces; f32 hd 256 puts 2 pieces on each of 32 lanes)."""
    pieces = hd * _ELEMENT_BYTES[dtype] // 16
    return min(32, max(2, 1 << (pieces - 1).bit_length()))


def launch_geometry(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
                    dtype: torch.dtype, kv_dtype=None) -> Geometry:
    """The form and grid the kernel launches with (see ``Geometry``);
    ``kv_dtype`` torch.int8 is the int8 cache (decode form only)."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    G = H // KV
    rows = Sq * G
    if rows <= DECODE_ROWS:
        splits = 1
        if B * KV < SMS and Sk >= 2 * MIN_SPLIT_KEYS:
            splits = min(MAX_SPLITS, -(-SPLIT_TARGET_CTAS // (B * KV)),
                         Sk // MIN_SPLIT_KEYS)
        chunk = -(-Sk // splits)
        splits = -(-Sk // chunk)
        return Geometry("decode", (B * KV, splits), 32 * DECODE_WARPS, rows,
                        splits, chunk,
                        32 // decode_lanes(hd, kv_dtype) * DECODE_WARPS)
    if kv_dtype == torch.int8:
        raise ValueError(
            f"the int8 KV cache takes the decode form only (Sq * G <= "
            f"{DECODE_ROWS} rows a kv head), got {rows}")
    if dtype == torch.float32:
        row_tile = F32_ROW_TILE
    else:   # the largest tile of 4, 2, 1 warps (16 rows each) that fills
        row_tile = 16
        for warps in (4, 2):
            if -(-rows // (16 * warps)) * B * KV >= SMS:
                row_tile = 16 * warps
                break
    block = 32 * (row_tile // 16) if dtype == torch.bfloat16 else 256
    return Geometry("forward", (B * KV, -(-rows // row_tile)), block,
                    row_tile, 1, Sk, FORWARD_KEY_TILE[dtype])

LAUNCHES = 0
INT8_LAUNCHES = 0
LOWP_LAUNCHES = {1: 0, 2: 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, ctypes.c_float, i, i, i, i, p]
        fn.restype = i
        lib.repro_flash_decode_int8.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, p,
            i, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        lib.repro_flash_decode_int8.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, q_pos, k_pos, k_scale=None, v_scale=None) -> Geometry:
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k, v, q_pos, k_pos, k_scale, v_scale)
               if t is not None):
        raise ValueError("flash_attention: every tensor must be on one CUDA "
                         "device")
    return _check_layout(q, k, v, q_pos, k_pos, k_scale, v_scale)


def _check_scales(k, k_scale, v_scale) -> None:
    """The int8 cache: int8 k / v and contiguous f32 scales (B, Sk, KV)."""
    if k.dtype != torch.int8 or v_scale is None:
        raise TypeError("flash_attention: k_scale and v_scale go with int8 "
                        f"k / v (the int8 KV cache), got k {k.dtype}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(k.shape[:3]):
            raise ValueError(f"flash_attention: {name} must be f32 "
                             f"{tuple(k.shape[:3])}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 4-byte aligned")


def _check_layout(q, k, v, q_pos, k_pos, k_scale=None,
                  v_scale=None) -> Geometry:
    """Types, shapes, contiguity and alignment the kernel takes, on any
    device; returns the launch geometry."""
    kv_dtype = q.dtype
    if k_scale is not None:
        _check_scales(k, k_scale, v_scale)
        kv_dtype = torch.int8
    if q.dtype not in _DTYPES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q/k/v of one "
                        f"dtype, or int8 k/v with scales, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("flash_attention positions must be int32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,Sq,H,hd), k/v (B,Sk,KV,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if tuple(q_pos.shape) != (B, Sq) or tuple(k_pos.shape) != (B, k.shape[1]):
        raise ValueError("flash_attention: positions must be (B, Sq) and "
                         "(B, Sk)")
    for t in (q, k, v, q_pos, k_pos):
        if not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous tensors")
    # 16-byte vector loads and cp.async: aligned bases and row pitches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or (hd * t.element_size()) % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary with 16-byte rows")
    for name, t in (("q_pos", q_pos), ("k_pos", k_pos)):
        if t.data_ptr() % 4:
            raise ValueError(f"flash_attention: {name} must be 4-byte "
                             f"aligned")
    geo = launch_geometry(B, Sq, k.shape[1], H, k.shape[2], hd, q.dtype,
                          kv_dtype)
    if geo.grid[1] > _MAX_ROW_TILES or geo.grid[0] > _MAX_CTAS_X:
        raise ValueError("flash_attention: too many query rows for one grid")
    return geo


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = -1, partial: bool = False,
                    stats: bool = False, k_scale=None, v_scale=None,
                    lowp: int = 0):
    """Launch the kernel on CUDA tensors (see ``ref.flash_attention`` for
    the function): q (B, Sq, H, hd), k/v (B, Sk, KV, hd), int32 positions
    (B, Sq)/(B, Sk). With ``stats`` (and not ``partial``) it returns
    ``(out, m, l)``: the output and the f32 row statistics (B, H, Sq) the
    backward reads, from the same launch (``out`` is bit-identical to the
    launch without them). With ``k_scale`` / ``v_scale`` (B, Sk, KV) f32,
    k and v are the int8 cache's codes and the decode form's int8
    instances read them (Sq * G <= 8 rows a kv head; no ``stats``).
    ``lowp`` 1 / 2 runs the bf16 forms in the reference's low-precision
    mode (``ref.flash_attention``); on f32 q the mode is 0.
    Raises on anything the kernel does not take, and under grad
    (``guard_grad``)."""
    global LAUNCHES, INT8_LAUNCHES
    guard_grad("flash_attention", q, k, v)
    geo = _check(q, k, v, q_pos, k_pos, k_scale, v_scale)
    int8 = k_scale is not None
    if lowp not in (0, 1, 2):
        raise ValueError(f"flash_attention: lowp must be 0, 1 or 2, got "
                         f"{lowp}")
    if int8 and lowp:
        raise ValueError("flash_attention: the int8 KV cache takes no "
                         f"low-precision mode, got lowp={lowp}")
    mode = lowp if q.dtype == torch.bfloat16 else 0
    if int8 and stats:
        raise ValueError("flash_attention: the int8 cache has no training "
                         "forward (stats=True)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = acc = m = l = None
    if partial or stats:
        m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if partial:
        acc = torch.empty((B, H, Sq, hd), dtype=torch.float32,
                          device=q.device)
    else:
        out = torch.empty_like(q)
    lib = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if int8:
            rc = lib.repro_flash_decode_int8(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), q_pos.data_ptr(),
                k_pos.data_ptr(), ptr(out), ptr(acc), ptr(m), ptr(l), B, Sq,
                Sk, H, KV, hd, int(causal), int(window), hd ** -0.5,
                geo.row_tile, geo.key_splits, stream)
        else:
            rc = lib.repro_flash_attention(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                q_pos.data_ptr(), k_pos.data_ptr(), ptr(out), ptr(acc),
                ptr(m), ptr(l), B, Sq, Sk, H, KV, hd, int(causal),
                int(window), hd ** -0.5, 0 if geo.form == "decode" else 1,
                geo.row_tile, geo.key_splits, mode, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    if int8:
        INT8_LAUNCHES += 1
    else:
        LAUNCHES += 1
        if mode:
            LOWP_LAUNCHES[mode] += 1
    if partial:
        return acc, m, l
    return (out, m, l) if stats else out
