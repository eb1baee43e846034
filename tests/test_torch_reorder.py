"""The port's reorder (PE-assisted reordering, the tile swizzle) held against
the JAX package: the plain PyTorch version that the CPU takes, behind the
same dispatch as the Hopper kernel, bit-equal to the Pallas kernel in
interpret mode over the sweep of ``tests/test_kernels.py``. Inputs come from
a NumPy seed; bf16 inputs are rounded once and handed to both. The kernel
itself runs only on the card (``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.reorder import ref as jax_ref
from repro.kernels.reorder.reorder import (
    block_transpose as pallas_block_transpose,
    tile_swizzle as pallas_tile_swizzle)

from repro_torch.kernels.reorder import ops, ref, reorder

SWEEP = [(4, 8, 128), (8, 16, 64), (16, 4, 256)]


def _inputs(seed, shape, dtype):
    a = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,b,D", SWEEP)
def test_tile_swizzle_sweep(dtype, G, b, D):
    x, jx = _inputs(1, (G * b, D), dtype)
    perm = np.random.RandomState(G).permutation(G)
    got = ops.tile_swizzle(x, perm)
    assert got.dtype == x.dtype and got.shape == x.shape
    want = pallas_tile_swizzle(jx, perm, interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        _np(got), np.asarray(jax_ref.tile_swizzle(jx, perm), np.float32))


@pytest.mark.parametrize("g1,g2", [(2, 4), (4, 2), (2, 2)])
def test_block_transpose(g1, g2):
    x, jx = _inputs(2, (g1 * g2 * 8, 32), "float32")
    got = ref.block_transpose(x, g1, g2)
    want = pallas_block_transpose(jx, g1, g2, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kernel's permutation is the plain transpose's
    np.testing.assert_array_equal(
        ref.tile_swizzle(x, reorder.block_transpose_perm(g1, g2)).numpy(),
        got.numpy())


def test_int32_payload_and_one_row_blocks():
    x = torch.from_numpy(np.random.RandomState(3).randint(
        -9, 9, (12, 5)).astype(np.int32))
    perm = [3, 0, 11, 1, 2, 10, 9, 4, 8, 7, 6, 5]
    got = ops.tile_swizzle(x, perm)
    np.testing.assert_array_equal(got.numpy(), x.numpy()[perm])
    # a block may hold a part of a row: 12 rows of 5 as 30 blocks of 2
    perm30 = np.random.RandomState(4).permutation(30)
    flat = ops.tile_swizzle(x.reshape(30, 2), perm30)
    np.testing.assert_array_equal(
        flat.numpy(), x.numpy().reshape(30, 2)[perm30])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        reorder.tile_swizzle(x, [0, 1])
    with pytest.raises(ValueError, match="split"):
        ref.tile_swizzle(x, [0, 1, 2])
    with pytest.raises(ValueError, match="perm entries"):
        reorder._device_perm([0, 2], x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.RandomState(5)
    for G, b, D in SWEEP + [(8, 1, 3), (5, 3, 7)]:
        x = torch.from_numpy(rng.randint(-100, 100, (G * b, D))).to(
            getattr(torch, dtype)).cuda()
        perm = torch.from_numpy(rng.permutation(G)).to(torch.int32).cuda()
        before = reorder.LAUNCHES
        got = ops.tile_swizzle(x, perm)
        torch.cuda.synchronize()
        assert reorder.LAUNCHES == before + 1
        assert torch.equal(got, ref.tile_swizzle(x, perm))
        # an unaligned base pointer takes the narrow-word path
        xs = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        xs[1:] = x.reshape(-1)
        xo = xs[1:].view(G * b, D)
        assert torch.equal(ops.tile_swizzle(xo, perm),
                           ref.tile_swizzle(xo, perm))


@pytest.mark.cuda
def test_kernel_index_widths_on_the_card():
    """The kernel (``reorder.plan``) against the plain version on 32-bit
    indices (65,536 blocks of 256 B; 832-B, 4-KiB and 160-KiB blocks) and
    on 64-bit ones (2^31 + 2 words of 2 bytes, a 4.3 GB payload), with a
    zero block from an out-of-range entry below and above [0, G) in each;
    each launch's plan (``LAST_PLAN``) checked too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for G, D, dtype, width, bits in (
            (65536, 128, torch.bfloat16, 16, 32),
            (4096, 208, torch.float32, 16, 32),
            (1024, 1024, torch.int32, 16, 32),
            (16, 81920, torch.bfloat16, 16, 32),
            (2 ** 31 // 1025 + 1, 1025, torch.bfloat16, 2, 64)):
        x = torch.randint(-2 ** 15, 2 ** 15, (G, D), generator=gen,
                          device="cuda", dtype=torch.int16)
        x = x.view(dtype) if dtype == torch.bfloat16 else x.to(dtype)
        perm = torch.randperm(G, generator=gen, device="cuda").to(
            torch.int32)
        bits16 = (lambda t: t.view(torch.int16)) if dtype == torch.bfloat16 \
            else (lambda t: t)        # random bf16 bits hold NaNs
        assert torch.equal(bits16(ops.tile_swizzle(x, perm)),
                           bits16(ref.tile_swizzle(x, perm)))
        g = reorder.LAST_PLAN
        assert (g.width, g.index_bits) == (width, bits)
        bad = perm.clone()
        bad[1], bad[G // 2] = -1, G
        got = ops.tile_swizzle(x, bad)
        want = ref.tile_swizzle(x, perm)
        want[[1, G // 2]] = 0
        torch.cuda.synchronize()
        assert torch.equal(bits16(got), bits16(want))
        del x, perm, bad, got, want
    torch.cuda.empty_cache()
