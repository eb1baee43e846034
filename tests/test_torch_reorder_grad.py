"""The reorder under autograd: ``TileSwizzle``, whose backward is the same
reorder with the inverse permutation (on the card the same kernel), held
bit for bit to autograd of ``index_select`` and, through every registered
all_to_all flow, to autograd of a plain transpose written here, on
integer payloads (every sum exact). The inverse the communicator caches
beside each block permutation is ``argsort`` of it. The kernel itself
runs only on the card (``cuda`` marker)."""
import numpy as np
import pytest
import torch

from repro.testing.substrate import integer_payload

from repro_torch.core.hypercube import Hypercube
from repro_torch.kernels.reorder import ops, ref, reorder

CUBES = {"ring8": {"d": 8}, "2x4": {"r": 2, "c": 4},
         "2x2x2": {"a": 2, "b": 2, "c": 2}}
CELLS = [("ring8", "1"), ("2x4", "01"), ("2x2x2", "010"), ("2x2x2", "110"),
         ("2x2x2", "011")]
FLOWS = ["naive", "pr", "im", "cm"]
# (split_axis, concat_axis): both orders, the same axis, the MoE pair
AXES = [(0, 1), (1, 0), (0, 0), (1, 2)]


def _index_select_grad(x, perm, dy):
    G = len(perm)
    xs = x.detach().clone().requires_grad_()
    y = torch.index_select(xs.reshape(G, -1), 0,
                           torch.as_tensor(perm).long().to(x.device)
                           ).reshape(x.shape)
    (g,) = torch.autograd.grad(y, xs, dy)
    return y, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,b,D", [(4, 8, 16), (8, 1, 64), (16, 4, 8)])
def test_tile_swizzle_grad_is_index_selects(dtype, G, b, D):
    rng = np.random.RandomState(G * b)
    x = torch.from_numpy(rng.randint(-9, 9, (G * b, D)).astype(
        np.float32)).to(dtype).requires_grad_()
    dy = torch.from_numpy(rng.randint(-9, 9, (G * b, D)).astype(
        np.float32)).to(dtype)
    perm = rng.permutation(G)
    for p, inv in ((perm, ops.inverse_perm(perm)),
                   (torch.as_tensor(perm, dtype=torch.int32),
                    ops.inverse_perm(perm).to(torch.int32))):
        y = ops.tile_swizzle(x, p, inv)
        (g,) = torch.autograd.grad(y, x, dy)
        y_ref, g_ref = _index_select_grad(x, perm, dy)
        assert torch.equal(y, y_ref) and torch.equal(g, g_ref)
        assert g.dtype == dtype


def test_inverse_perm_is_argsort_and_refuses_non_bijections():
    rng = np.random.RandomState(0)
    for G in (1, 2, 7, 64):
        perm = rng.permutation(G)
        inv = ops.inverse_perm(perm)
        assert torch.equal(inv, torch.argsort(torch.as_tensor(perm)))
        assert torch.equal(torch.as_tensor(perm)[inv], torch.arange(G))
    assert ops.inverse_perm([0, 0, 1]) is None
    assert ops.inverse_perm([0, 3, 1]) is None


def test_non_bijective_perm_raises_under_grad_only():
    x = torch.arange(12.0).reshape(6, 2)
    perm = [0, 0, 2]
    inv = ops.inverse_perm(perm)
    assert inv is None
    # without grad the reorder copies blocks, repeats and all
    torch.testing.assert_close(ops.tile_swizzle(x, perm, inv),
                               ref.tile_swizzle(x, perm))
    with pytest.raises(ValueError, match="bijection"):
        ops.tile_swizzle(x.requires_grad_(), perm, inv)


def test_direct_launch_still_raises_under_grad():
    """``guard_grad`` stays on the raw launcher: only ``TileSwizzle``
    carries the gradient."""
    x = torch.zeros(8, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        reorder.tile_swizzle(x, [0, 1])


def _plain_group(x, sizes, axes):
    n = len(sizes)
    inst = [i for i in range(n) if i not in axes]
    perm = list(axes) + inst + list(range(n, x.dim()))
    y = x.permute(perm)
    gshape = [sizes[a] for a in axes]
    y = y.reshape([int(np.prod(gshape))] + list(y.shape[len(axes):]))

    def back(z):
        z = z.reshape(gshape + list(z.shape[1:]))
        return z.permute([perm.index(i) for i in range(len(perm))])
    return y, back


def _plain_all_to_all(x, sizes, axes, split_axis, concat_axis):
    """Member j's block i along concat_axis = member i's block j along
    split_axis, as views, chunks and one concatenation."""
    y, back = _plain_group(x, sizes, axes)
    g = y.shape[0]
    pay0 = y.dim() - (x.dim() - len(sizes))
    blocks = torch.stack(torch.chunk(y, g, dim=pay0 + split_axis), dim=1)
    swapped = blocks.transpose(0, 1)
    return back(torch.cat([swapped[:, s] for s in range(g)],
                          dim=pay0 + concat_axis))


@pytest.mark.parametrize("cube_name,bitmap", CELLS)
@pytest.mark.parametrize("flow", FLOWS)
def test_all_to_all_grads_match_plain_transpose(cube_name, bitmap, flow):
    cube = Hypercube.build(CUBES[cube_name])
    c = cube.comm(bitmap)
    g = c.group_size
    axes = [i for i, b in enumerate(bitmap) if b == "1"]
    x = torch.from_numpy(integer_payload(cube, (2 * g, g, 4 * g), seed=5))
    dy = torch.from_numpy(integer_payload(cube, (2 * g, g, 4 * g), seed=6))
    for sa, ca in AXES:
        xs = x.clone().requires_grad_()
        got = c.all_to_all(xs, split_axis=sa, concat_axis=ca,
                           algorithm=flow)
        dyc = dy.reshape(got.shape)
        (gx,) = torch.autograd.grad(got, xs, dyc)
        xp = x.clone().requires_grad_()
        want = _plain_all_to_all(xp, cube.dim_sizes, axes, sa, ca)
        (gw,) = torch.autograd.grad(want, xp, dyc)
        assert torch.equal(got.detach(), want.detach()), (sa, ca)
        assert torch.equal(gx, gw), (sa, ca)


@pytest.mark.parametrize("flow", ["pr", "cm"])
def test_cached_inverse_is_argsort_of_the_perm(flow):
    """The reorder flows cache (perm, unit, inv) once per (move, shape,
    device); inv is ``argsort`` of perm."""
    cube = Hypercube.build(CUBES["2x2x2"])
    c = cube.comm("011")
    x = torch.from_numpy(integer_payload(cube, (8, 4, 16), seed=1))
    c.all_to_all(x, split_axis=0, concat_axis=1, algorithm=flow)
    (perm, unit, inv), = c._perms.values()
    assert perm.dtype == inv.dtype == torch.int32
    assert torch.equal(inv.long(), torch.argsort(perm.long()))
    assert unit * perm.numel() == x.numel()


@pytest.mark.cuda
def test_reorder_grad_on_the_card():
    """On the card the backward launches the kernel with the inverse
    permutation: bit-identical to autograd of ``index_select``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((64, 48)).astype(
            np.float32)).to(dev, dtype).requires_grad_()
        dy = torch.randn(64, 48, device=dev).to(dtype)
        perm = rng.permutation(16)
        p = torch.as_tensor(perm, dtype=torch.int32, device=dev)
        inv = ops.inverse_perm(perm).to(dev, torch.int32)
        n0 = reorder.LAUNCHES
        y = ops.tile_swizzle(x, p, inv)
        (g,) = torch.autograd.grad(y, x, dy)
        torch.cuda.synchronize()
        assert reorder.LAUNCHES - n0 == 2
        y_ref, g_ref = _index_select_grad(x, perm, dy)
        assert torch.equal(y, y_ref) and torch.equal(g, g_ref)
