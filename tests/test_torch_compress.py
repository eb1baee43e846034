"""The §V-C int8 compressed flow of the port held to the JAX package's
``repro.core.compress`` on the same NumPy-seeded inputs.

* ``quantize_int8`` / ``dequantize_int8``: equal to JAX's, bit for bit;
* the compressed all-reduce and its error-feedback term: against JAX's
  ``compressed_pod_all_reduce`` run under ``shard_map`` on the 8-PE
  ``pod2x2x2`` cube, and on the 16-PE ``pod2x4x2`` cube (which the
  in-process JAX suite cannot boot) against the reference's hops composed
  from JAX's own quantizer with NumPy collectives; within
  ``TOL`` x max(1, max|ref|) (the ICI reduce sums a random payload in
  another order: 1.9e-6 at a max of 25 reads on the CPU), and further than
  that from the exact all-reduce, so a flow that skipped the int8 hop
  fails;
* the backward through ``torch.autograd``: the reference's straight-through
  ``custom_vjp`` (``jax.grad`` under ``shard_map``), within the same bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jax_compress
from repro.testing import oracles, substrate

from repro_torch.core import compress
from repro_torch.core.hypercube import Hypercube

# relative to max(1, max|ref|): f32 sums in another order, far below half an
# int8 step (max / 254) of the payloads here
TOL = 1e-6

POD_CUBES = {"pod2x2x2": {"pod": 2, "dp": 2, "tp": 2},
             "pod2x4x2": {"pod": 2, "dp": 4, "tp": 2}}


def _payload(cube_sizes, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*(tuple(cube_sizes) + (n,)))
            * rng.rand(*(tuple(cube_sizes) + (n,))) * 4).astype(np.float32)


@pytest.mark.parametrize("n,block", [(1000, 256), (4096, 64), (7, 256),
                                     (300, 100)])
def test_quantize_dequantize_match_jax(n, block):
    x = _payload((), n, seed=n)
    jq, js = jax_compress.quantize_int8(jnp.asarray(x), block)
    q, s = compress.quantize_int8(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compress.dequantize_int8(q, s, (n,), n).numpy(),
        np.asarray(jax_compress.dequantize_int8(jq, js, (n,), n)))


def test_round_half_to_even():
    """0.5 and 2.5 steps round to the even level, as ``jnp.round`` does."""
    x = torch.tensor([127.0, 0.5, 2.5, -1.5, 3.5])
    q, s = compress.quantize_int8(x, block=5)
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, -2, 4]]


def _jax_pod2x2x2(x, dims, fn_kind):
    """JAX's compressed flow on the 8-PE pod cube under shard_map: the
    (full, err) pair, or the gradient of sum(y * c) for x = v[..., 0, :]
    and c = v[..., 1, :]."""
    cube = substrate.build_cube("pod2x2x2")
    fast, slow = cube.split_fast_slow(dims)
    if fn_kind == "pair":
        def fn(v):
            full, err = jax_compress.compressed_pod_all_reduce(
                v, cube, fast, slow)
            return jnp.stack([full, err], axis=-1)
        return substrate.run_per_shard(cube, fn, x, out_payload_ndim=2)

    def fn(v):
        xs, cs = v[..., 0, :], v[..., 1, :]
        return jax.grad(lambda a: jnp.sum(
            jax_compress.compressed_all_reduce(a, cube, dims) * cs))(xs)
    return substrate.run_per_shard(cube, fn, x, out_payload_ndim=1)


def _numpy_hops(x, cube, dims, block=256):
    """The reference's ``_compressed_hops`` on a global-layout array: the
    ICI / DCN collectives from ``repro.testing.oracles``, the quantizer
    JAX's own, per PE."""
    fast, slow = cube.split_fast_slow(dims)
    nd = cube.ndim
    fidx = [cube.dim_names.index(d) for d in fast]
    sidx = [cube.dim_names.index(d) for d in slow]
    gf = cube.group_size(fast)
    n = x.shape[-1]
    pad = (-n) % (gf * block)
    flat = np.pad(x, [(0, 0)] * nd + [(0, pad)])
    shard = oracles.reduce_scatter(flat, nd, fidx, axis=0) if fidx else flat
    deq = np.empty_like(shard)
    for pe in np.ndindex(*cube.dim_sizes):
        q, s = jax_compress.quantize_int8(jnp.asarray(shard[pe]), block)
        deq[pe] = np.asarray(jax_compress.dequantize_int8(
            q, s, shard[pe].shape, shard[pe].size))
    err = shard - deq
    full = oracles.all_reduce(deq, nd, sidx)
    if fidx:
        full = oracles.all_gather(full, nd, fidx, axis=0)
        err = oracles.all_gather(err, nd, fidx, axis=0)
    return full[..., :n], err[..., :n]


def _tol(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


def _exact(x, cube, dims):
    return oracles.all_reduce(x, cube.ndim,
                              [cube.dim_names.index(d) for d in dims])


@pytest.mark.parametrize("dims", [("pod", "dp"), ("pod",),
                                  ("pod", "dp", "tp")])
def test_compressed_pod_all_reduce_matches_jax_pod2x2x2(dims):
    cube = Hypercube.build(POD_CUBES["pod2x2x2"], pods=2)
    x = _payload(cube.dim_sizes, 600, seed=1)
    ref = _jax_pod2x2x2(x, dims, "pair")
    full, err = compress.compressed_pod_all_reduce(
        torch.from_numpy(x), cube, *cube.split_fast_slow(dims))
    tol = _tol(ref[..., 0])
    assert np.abs(full.numpy() - ref[..., 0]).max() <= tol
    assert np.abs(err.numpy() - ref[..., 1]).max() <= tol
    assert np.abs(full.numpy() - _exact(x, cube, dims)).max() > tol


@pytest.mark.parametrize("bitmap", ["110", "100", "111"])
def test_compressed_all_reduce_pod2x4x2(bitmap):
    """The 16-PE pod cube: the registry flow and the error-feedback pair
    against the reference's hops; the error term closes the gap to the
    exact all-reduce."""
    cube = Hypercube.build(POD_CUBES["pod2x4x2"], pods=2)
    dims = cube.dims_from_bitmap(bitmap)
    x = _payload(cube.dim_sizes, 700, seed=2)
    want_full, want_err = _numpy_hops(x, cube, dims)
    tol = _tol(want_full)
    got = cube.comm(dims).all_reduce(torch.from_numpy(x),
                                     algorithm="compressed").numpy()
    assert np.abs(got - want_full).max() <= tol
    full, err = compress.compressed_pod_all_reduce(
        torch.from_numpy(x), cube, *cube.split_fast_slow(dims))
    np.testing.assert_array_equal(full.numpy(), got)
    assert np.abs(err.numpy() - want_err).max() <= tol
    # error feedback: full + the pods' errors summed is the exact result
    sidx = [cube.dim_names.index(d) for d in cube.split_fast_slow(dims)[1]]
    exact = _exact(x, cube, dims)
    assert np.abs(got - exact).max() > tol
    closed = full.numpy() + oracles.all_reduce(err.numpy(), cube.ndim, sidx)
    assert np.abs(closed - exact).max() <= 1e-5 * max(1.0,
                                                      np.abs(exact).max())


@pytest.mark.parametrize("dims", [("pod", "dp"), ("pod", "dp", "tp")])
def test_backward_matches_jax_grad(dims):
    """d/dx sum(compressed_all_reduce(x) * c) through autograd equals
    ``jax.grad`` through the reference's custom_vjp: the compressed
    all-reduce of the cotangent c."""
    cube = Hypercube.build(POD_CUBES["pod2x2x2"], pods=2)
    x = _payload(cube.dim_sizes, 500, seed=5)
    c = _payload(cube.dim_sizes, 500, seed=6)
    ref = _jax_pod2x2x2(np.stack([x, c], axis=-2), dims, "grad")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = compress.compressed_all_reduce(xt, cube, dims)
    (y * torch.from_numpy(c)).sum().backward()
    assert np.abs(xt.grad.numpy() - ref).max() <= _tol(ref)
    assert np.abs(xt.grad.numpy() - _exact(c, cube, dims)).max() > _tol(ref)
    # the straight-through rule: the gradient is the flow applied to c
    np.testing.assert_array_equal(
        xt.grad.numpy(),
        compress.compressed_all_reduce(torch.from_numpy(c), cube,
                                       dims).numpy())
    with pytest.raises(ValueError, match="DCN"):
        compress.compressed_all_reduce(xt, cube, ("dp",))


@pytest.mark.parametrize("payload", [4096.0, 1 << 20, 64 << 20])
@pytest.mark.parametrize("block,dtype_bytes", [(256, 4), (64, 2)])
def test_planner_compressed_estimate_matches_jax(payload, block,
                                                 dtype_bytes):
    """The §V-C byte model equals the reference's, and ``plan`` takes the
    compressed flow only when asked to (``allow_compressed``)."""
    from repro.core import planner as jax_planner
    from repro.testing.substrate import fake_cube
    from repro_torch.core import planner
    dims = {"pod": 2, "dp": 4, "tp": 2}
    jcube = fake_cube((2, 4, 2), ("pod", "data", "model"), dims)
    cube = Hypercube.build(dims, pods=2)
    for sel in (("pod", "dp"), ("pod",), ("pod", "dp", "tp")):
        want = jax_planner.estimate(jcube, "all_reduce", sel, payload,
                                    "compressed", dtype_bytes=dtype_bytes,
                                    block=block)
        got = planner.estimate(cube, "all_reduce", sel, payload,
                               "compressed", dtype_bytes=dtype_bytes,
                               block=block)
        assert (got.algorithm, got.stage, got.schedule) == (
            want.algorithm, want.stage, want.schedule)
        assert got.ici_bytes == pytest.approx(want.ici_bytes)
        assert got.dcn_bytes == pytest.approx(want.dcn_bytes)
        assert got.seconds is None
        assert planner.plan(cube, "all_reduce", sel, payload).algorithm != \
            "compressed"
        pick = planner.plan(cube, "all_reduce", sel, payload,
                            allow_compressed=True)
        assert pick.algorithm == jax_planner.plan(
            jcube, "all_reduce", sel, payload,
            allow_compressed=True).algorithm == "compressed"
