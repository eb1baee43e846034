"""``flash_bwd.launch_geometry`` on the CPU: the launch geometry of the
backward kernel's two passes (``csrc/flash_bwd.cu``), which the wrapper
passes to the C function and the C function checks. For bf16 and f32, at
the training layouts (qwen3-1.7b at 1 PE, tp 8 and data 2 x tp 4;
phi3-mini at 1 PE and tp 8; gemma3 at 1 PE and data 2 x tp 4; mixtral at 1
PE and ep 8) at every head dim the forward takes, and at the shapes of
``chip_smoke.py``'s ``FLASH_BWD_CASES`` at their own head dim: every row
and every key is owned by exactly one CTA of its pass; grid.y and shared
memory stay within Hopper's limits; bf16 takes the tensor-core form and
f32 the CUDA-core one; and the CTAs run heaviest first under a causal
mask. A head dim outside ``flash.HEAD_DIMS`` is refused."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.attention import flash, flash_bwd

ROOT = Path(__file__).resolve().parents[1]


def _smoke_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [c[:5] + (c[9],) for c in mod.FLASH_BWD_CASES]


# B, Sq, Sk, H, KV, hd of the bf16 training steps (4 x 1,024 tokens)
TRAIN_LAYOUTS = {"1pe": (4, 1024, 1024, 16, 8, 128),      # qwen3
                 "tp8": (32, 1024, 1024, 2, 1, 128),
                 "data2_tp4": (16, 1024, 1024, 4, 2, 128),
                 "phi3_1pe": (4, 1024, 1024, 32, 32, 96),
                 "phi3_tp8": (32, 1024, 1024, 4, 4, 96),
                 "gemma3_1pe": (4, 1024, 1024, 4, 1, 256),
                 "gemma3_data2_tp4": (16, 1024, 1024, 1, 1, 256),
                 "mixtral_1pe": (4, 1024, 1024, 32, 8, 128),
                 "mixtral_ep8": (32, 1024, 1024, 4, 1, 128)}
# every training layout at every head dim, and the kernel phase's cases
SHAPES = ([s[:5] + (hd,) for s in TRAIN_LAYOUTS.values()
           for hd in flash_bwd.HEAD_DIMS]
          + _smoke_cases())
DTYPES = [torch.bfloat16, torch.float32]


def _id(shape, dtype):
    """B x Sq x Sk x H x KV, then x hd where it is not 128."""
    dims = shape[:5] + (shape[5:] if shape[5] != 128 else ())
    return f"{'x'.join(map(str, dims))}-{str(dtype)[6:]}"


CASES = [pytest.param(s, d, id=_id(s, d))
         for s in dict.fromkeys(SHAPES) for d in DTYPES]


def _geometry(shape, dtype):
    return flash_bwd.launch_geometry(*shape, dtype)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_every_row_and_key_is_owned_once(shape, dtype):
    B, Sq, Sk, H, KV, hd = shape
    geo = _geometry(shape, dtype)
    for p, n in ((geo.dq, Sq * (H // KV)), (geo.dkdv, Sk)):
        assert p.grid[0] == B * KV
        tiles = [p.tile(y) for y in range(p.grid[1])]
        assert sorted(tiles) == list(range(p.grid[1]))
        owned = torch.zeros(n, dtype=torch.int64)
        for t in tiles:
            owned[t * p.own_tile:(t + 1) * p.own_tile] += 1
        assert bool((owned == 1).all())
        assert (p.grid[1] - 1) * p.own_tile < n


@pytest.mark.parametrize("shape,dtype", CASES)
def test_grid_and_shared_memory_within_limits(shape, dtype):
    geo = _geometry(shape, dtype)
    for p in (geo.dq, geo.dkdv):
        static = flash_bwd.MMA_STATIC_SMEM if p.form == "mma" else 0
        assert p.grid[1] <= 65535
        assert p.smem + static <= 232448
        assert p.block % 32 == 0 and p.block <= 1024


@pytest.mark.parametrize("shape,dtype", CASES)
def test_bf16_takes_tensor_cores_and_f32_cuda_cores(shape, dtype):
    geo = _geometry(shape, dtype)
    form = "mma" if dtype == torch.bfloat16 else "f32"
    assert geo.dq.form == geo.dkdv.form == form
    hd = shape[5]
    if dtype == torch.bfloat16:
        # a warp owns 16 rows or keys; at hd 256 two warps share 16 keys
        for p, share in ((geo.dq, 1), (geo.dkdv, 2 if hd == 256 else 1)):
            assert p.own_tile == 16 * (p.block // 32) // share
            assert p.stages >= 2
            assert p.block // 32 in flash_bwd.mma_warps(p.name, hd)
    else:
        assert geo.dq.block == geo.dkdv.block == 256
        assert geo.dq.own_tile == (64 if hd <= 128 else 32)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_heaviest_causal_tiles_start_first(shape, dtype):
    """Aligned causal positions (the training step's): in launch order,
    the visible pairs of each CTA of the dk / dv pass never rise (the
    earliest keys first), nor those per row of each CTA of the dq pass
    (the latest rows first; its ragged last tile, which starts, holds
    fewer rows)."""
    B, Sq, Sk, H, KV, hd = shape
    G = H // KV
    geo = _geometry(shape, dtype)
    q_pos = torch.arange(Sq).repeat_interleave(G)        # row r: r // G
    k_pos = torch.arange(Sk)
    seen = (k_pos[None, :] <= q_pos[:, None])            # (R, Sk)
    for p, per, mean in ((geo.dkdv, seen.sum(0), False),
                         (geo.dq, seen.sum(1), True)):
        work = []
        for y in range(p.grid[1]):
            part = per[p.tile(y) * p.own_tile:(p.tile(y) + 1) * p.own_tile]
            work.append(float(part.float().mean() if mean else part.sum()))
        assert all(a >= b for a, b in zip(work, work[1:])), (p.name, work)


@pytest.mark.parametrize("layout", TRAIN_LAYOUTS)
def test_training_layouts_fill_the_card(layout):
    """Each pass of the bf16 training step launches at least one CTA for
    each of the 132 SMs."""
    geo = _geometry(TRAIN_LAYOUTS[layout], torch.bfloat16)
    for p in (geo.dq, geo.dkdv):
        assert p.grid[0] * p.grid[1] >= flash_bwd.SMS


@pytest.mark.parametrize("dtype", DTYPES, ids=["bfloat16", "float32"])
def test_check_layout_refuses_misaligned_tensor_core_inputs(dtype):
    """The tensor-core form copies 16-byte pieces: a bf16 input that
    starts off a 16-byte boundary is refused; the f32 form takes it."""
    B, Sq, H, KV = 1, 8, 4, 2
    q = torch.zeros(B * Sq * H * 128 + 1, dtype=dtype)[1:].view(B, Sq, H, 128)
    k = torch.zeros(B, Sq, KV, 128, dtype=dtype)
    st = torch.zeros(B, H, Sq)
    pos = torch.arange(Sq, dtype=torch.int32)[None]
    args = (q, k, k, q, st, st, q, pos, pos)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="16-byte"):
            flash_bwd.check_layout(*args)
    else:
        assert flash_bwd.check_layout(*args).dq.form == "f32"


@pytest.mark.parametrize("hd", [8, 48, 80, 112, 192, 512])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bfloat16", "float32"])
def test_head_dims_outside_the_forwards_are_refused(hd, dtype):
    """``launch_geometry`` and ``check_layout`` raise on a head dim that
    ``flash.HEAD_DIMS`` does not hold; the backward takes exactly the
    forward's."""
    assert flash_bwd.HEAD_DIMS == flash.HEAD_DIMS == (16, 32, 64, 96, 128,
                                                      256)
    with pytest.raises(ValueError, match="head_dim"):
        flash_bwd.launch_geometry(1, 8, 8, 4, 2, hd, dtype)
    q = torch.zeros(1, 8, 4, hd, dtype=dtype)
    k = torch.zeros(1, 8, 2, hd, dtype=dtype)
    st = torch.zeros(1, 4, 8)
    pos = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="head_dim"):
        flash_bwd.check_layout(q, k, k, q, st, st, q, pos, pos)
