"""Wrapper of the hand-written Hopper flash-attention backward
(``csrc/flash_bwd.cu``).

The JAX package has no Pallas backward: its train step differentiates the
jnp ``chunked_attention`` (``repro.models.layers``), so this kernel
replaces no TPU kernel; it is the backward of ``flash.py``'s forward, and
``ref.flash_attention_backward`` is its plain version. One call is one
count in ``LAUNCHES``: it launches the dq pass (which also writes D =
rowsum(do * o)) and then the dk / dv pass on the current stream.
``flash_attention_partial_backward`` is the backward of the forward's
partial form (ring attention's hops), the same two passes with one run-time
flag set, counted in ``PARTIAL_LAUNCHES`` and not in ``LAUNCHES``;
``ref.flash_attention_partial_backward`` is its plain version.
``launch_geometry`` picks each pass's form, grid and CTA size from the
shapes (a pure function, so the CPU tests can check it): bf16 takes the
tensor-core passes (mma.sync, a cp.async ring of bf16 tiles), f32 the
CUDA-core ones (f32 arithmetic throughout, which the f32 gates need). The
source note says what bounds each and what its design does about it.

Every head dim of the forward (``flash.HEAD_DIMS``: 16 to 256). Shared
memory is a function of it: bf16 tiles have a row pitch of hd + 8
elements; f32 tiles hd + 1 floats, 64 rows up to hd 128 and 32 at 256. At
hd 256 in bf16 the ring holds 32 keys or rows a stage (two stages), the
dq pass reloads its Q and dO fragments from shared memory at every k-step
(132 KB with 4 warps, 198 KB with 8), and the dk / dv pass splits the head
dim between two warps that share each 16-key tile (a CTA of w warps owns
8 w keys: 84 KB with 2 warps, two CTAs an SM; 133 KB with 8).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, guard_grad
from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.flash import _DTYPES, SMS

HEAD_DIMS = flash.HEAD_DIMS
LAUNCHES = 0
PARTIAL_LAUNCHES = 0
MAX_GRID_Y = 65535
MAX_SMEM = 232448             # shared memory a CTA may have (bytes)
MMA_STATIC_SMEM = (1024 + 4) * 4   # bf16 kernels' static tile list
F32_THREADS = 256
MMA_WARPS = (8, 4)            # bf16 passes: warps a CTA, largest first


def f32_tile(hd: int) -> int:
    """f32 passes: rows of a query tile and keys of a key tile."""
    return 64 if hd <= 128 else 32


def pitch(hd: int) -> int:
    """bf16 row pitch in shared memory, elements (ldmatrix without bank
    conflicts)."""
    return hd + 8


def split(hd: int) -> int:
    """bf16 dk / dv pass: warps that share a 16-key tile, each holding dk
    and dv for hd / split columns."""
    return 2 if hd > 128 else 1


def mma_stages(hd: int, warps: int) -> int:
    return 3 if warps == 8 and hd <= 128 else 2


def stream_tile(hd: int) -> int:
    """bf16: keys (dq pass) or rows (dk / dv pass) a ring stage holds."""
    return 64 if hd <= 128 else 32


@dataclasses.dataclass(frozen=True)
class Pass:
    """One launch: ``grid`` = (B * KV, y) CTAs of ``block`` threads with
    ``smem`` bytes of dynamic shared memory. CTA (x, y) serves batch
    x // KV, kv head x % KV and owns tile ``tile(y)`` of ``own_tile`` rows
    (the dq pass) or keys (the dk / dv pass); it loops over the other side,
    ``stream_tile`` at a time through a ring of ``stages`` tiles. A query
    row is (position, group member): row r is position r // G of query
    head kv_head * G + r % G."""
    name: str                 # "dq" or "dkdv"
    form: str                 # "mma" (bf16, tensor cores) or "f32"
    grid: tuple[int, int]
    block: int
    own_tile: int
    stream_tile: int
    stages: int
    smem: int
    reversed: bool            # y runs the tiles last first

    def tile(self, y: int) -> int:
        """The tile CTA row y owns: launch order is y order."""
        return self.grid[1] - 1 - y if self.reversed else y


@dataclasses.dataclass(frozen=True)
class Geometry:
    dq: Pass
    dkdv: Pass


def _f32_smem(name: str, hd: int) -> int:
    """``F32Layout<hd>::DQ_SMEM`` / ``DKDV_SMEM`` of the source."""
    t = f32_tile(hd)
    ld, lds = hd + 1, t + 16
    scores = 1 if name == "dq" else 2
    return (4 * t * ld + scores * t * lds + 3 * t) * 4 + 2 * t * 4


def _mma_own(name: str, warps: int, hd: int) -> int:
    """Rows (dq) or keys (dk / dv) a bf16 CTA owns."""
    return 16 * warps // (split(hd) if name == "dkdv" else 1)


def _mma_smem(name: str, warps: int, hd: int) -> int:
    """``MmaLayout<hd, warps>::DQ_SMEM`` / ``DKDV_SMEM`` of the source."""
    stages, st = mma_stages(hd, warps), stream_tile(hd)
    tile = st * pitch(hd) * 2
    own = _mma_own(name, warps, hd)
    owned = 2 * own * pitch(hd) * 2
    if name == "dq":      # K, V and key positions a stage
        return owned + stages * (2 * tile + st * 4)
    # Q, dO and the rows' m, l, D and positions a stage; key positions
    return owned + stages * (2 * tile + 4 * st * 4) + own * 4


def mma_warps(name: str, hd: int) -> tuple[int, ...]:
    """The CTA sizes (warps) of a bf16 pass that fit in shared memory at
    ``hd`` beside the static tile list, largest first: 8 and 4, and 2 in a
    dk / dv pass whose two warps share a key tile (one 16-key tile a
    CTA)."""
    sizes = MMA_WARPS + ((2,) if name == "dkdv" and split(hd) == 2 else ())
    return tuple(w for w in sizes
                 if _mma_smem(name, w, hd) + MMA_STATIC_SMEM <= MAX_SMEM)


def _check_head_dim(hd: int, name: str = "flash_attention_backward"
                    ) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")


def launch_geometry(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
                    dtype: torch.dtype) -> Geometry:
    """The form, grid and CTA size of both passes (see ``Pass``). The dq
    pass owns row tiles and runs them last first (under a causal mask the
    latest rows see the most keys); the dk / dv pass owns key tiles and
    runs them first to last (the earliest keys are seen by the most rows),
    so the heaviest CTAs start first. A bf16 pass takes the largest CTA
    (``mma_warps``) whose grid still reaches the 132 SMs, else the
    smallest."""
    _check_head_dim(hd)
    R = Sq * (H // KV)

    def one(name: str, n: int) -> Pass:
        if dtype == torch.float32:
            t = f32_tile(hd)
            return Pass(name, "f32", (B * KV, -(-n // t)), F32_THREADS, t, t,
                        1, _f32_smem(name, hd), name == "dq")
        fits = mma_warps(name, hd)
        warps = next((w for w in fits
                      if -(-n // _mma_own(name, w, hd)) * B * KV >= SMS),
                     fits[-1])
        own = _mma_own(name, warps, hd)
        return Pass(name, "mma", (B * KV, -(-n // own)), 32 * warps, own,
                    stream_tile(hd), mma_stages(hd, warps),
                    _mma_smem(name, warps, hd), name == "dq")

    return Geometry(one("dq", R), one("dkdv", Sk))


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    fn = lib.repro_flash_attention_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # dtype, 13 pointers, B .. window, scale, 3 ints of each pass's
        # geometry, partial, stream
        fn.argtypes = ([i] + [p] * 13 + [i] * 8 + [ctypes.c_float]
                       + [i] * 7 + [p])
        fn.restype = i
        lib.repro_flash_bwd_error_string.argtypes = [i]
        lib.repro_flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_layout(q, k, v, o, m, l, do, q_pos, k_pos, *,
                 name: str = "flash_attention_backward") -> Geometry:
    """Types, shapes, contiguity and alignment the kernel takes, on any
    device; returns the launch geometry. ``name``: the entry point the
    messages name."""
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, do)):
        raise TypeError(f"{name} takes f32 or bf16 q/k/v/o/do of one "
                        "dtype")
    if m.dtype != torch.float32 or l.dtype != torch.float32:
        raise TypeError(f"{name}: m and l must be f32")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError(f"{name}: positions must be int32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B,Sq,H,hd), k/v (B,Sk,KV,hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"{name}: incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    _check_head_dim(hd, name)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{name}: o and do must be q's shape")
    if tuple(m.shape) != (B, H, Sq) or tuple(l.shape) != (B, H, Sq):
        raise ValueError(f"{name}: m and l must be (B, H, Sq)")
    if tuple(q_pos.shape) != (B, Sq) or tuple(k_pos.shape) != (B, Sk):
        raise ValueError(f"{name}: positions must be (B, Sq) and (B, Sk)")
    for t in (q, k, v, o, m, l, do, q_pos, k_pos):
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    geo = launch_geometry(B, Sq, Sk, H, KV, hd, q.dtype)
    if geo.dq.form == "mma":   # 16-byte cp.async pieces, 8-byte do / o loads
        for arg, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {arg} must start on a 16-byte "
                                 "boundary")
    for p in (geo.dq, geo.dkdv):
        static = MMA_STATIC_SMEM if p.form == "mma" else 0
        if p.grid[1] > MAX_GRID_Y or p.smem + static > MAX_SMEM:
            raise ValueError(f"{name}: the {p.name} pass needs grid.y "
                             f"{p.grid[1]} and {p.smem} bytes of shared "
                             "memory")
    return geo


def _launch(name, q, k, v, o, m, l, do, q_pos, k_pos, delta, causal,
            window, partial: bool):
    """Both passes on ``q``'s current stream; returns (dq, dk, dv)."""
    tensors = (q, k, v, o, m, l, do, q_pos, k_pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    geo = check_layout(*tensors, name=name)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention_backward(
            _DTYPES[q.dtype],
            *(t.data_ptr() for t in (q, k, v, o, do, m, l, q_pos, k_pos)),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, Sq, Sk, H, KV, hd, int(causal), int(window), hd ** -0.5,
            *(x for p in (geo.dq, geo.dkdv)
              for x in (p.grid[1], p.block, p.smem)),
            int(partial), stream)
    if rc != 0:
        msg = lib.repro_flash_bwd_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    return dq, dk, dv


def flash_attention_backward(q, k, v, o, m, l, do, q_pos, k_pos, *,
                             causal: bool = True, window: int = -1):
    """Launch the backward on CUDA tensors (see
    ``ref.flash_attention_backward`` for the function). Returns
    ``(dq, dk, dv)`` in the inputs' dtype. Deterministic: two calls on the
    same inputs give the same bits."""
    global LAUNCHES
    guard_grad("flash_attention_backward", q, k, v, o, do)
    B, Sq, H, _ = q.shape
    # scratch: D = rowsum(do * o), then (bf16) 1 / max(l, 1e-30)
    delta = torch.empty((2, B, H, Sq), dtype=torch.float32, device=q.device)
    out = _launch("flash_attention_backward", q, k, v, o, m, l, do, q_pos,
                  k_pos, delta, causal, window, False)
    LAUNCHES += 1
    return out


def flash_attention_partial_backward(q, k, v, m, dacc, dl, q_pos, k_pos, *,
                                     causal: bool = True, window: int = -1):
    """Launch the backward of the forward's partial form on CUDA tensors
    (see ``ref.flash_attention_partial_backward`` for the function): m,
    dl f32 (B, H, Sq), dacc f32 (B, H, Sq, hd). Returns ``(dq, dk, dv)`` in
    the inputs' dtype; deterministic. dacc goes to the kernel as its do, in
    q's layout and dtype (one copy), and the delta scratch holds -dl and
    1."""
    global PARTIAL_LAUNCHES
    name = "flash_attention_partial_backward"
    guard_grad(name, q, k, v, dacc, dl)
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, Sq, H, hd), got "
                         f"{tuple(q.shape)}")
    B, Sq, H, hd = q.shape
    for arg, t, shape in (("m", m, (B, H, Sq)), ("dacc", dacc, (B, H, Sq, hd)),
                          ("dl", dl, (B, H, Sq))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not all(t.is_cuda and t.device == q.device for t in (dacc, dl)):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    do = dacc.transpose(1, 2).to(q.dtype).contiguous()     # (B, Sq, H, hd)
    delta = torch.empty((2, B, H, Sq), dtype=torch.float32, device=q.device)
    torch.neg(dl, out=delta[0])
    delta[1].fill_(1.0)
    out = _launch(name, q, k, v, do, m, delta[1], do, q_pos, k_pos, delta,
                  causal, window, True)
    PARTIAL_LAUNCHES += 1
    return out
