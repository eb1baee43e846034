"""The port's backward-overlapped gradient sync (``repro_torch.runtime.
overlap``), after ``tests/test_backward_overlap.py``: reverse-layer buckets
equal to the JAX package's on the same tree; the hooked sync (autograd
multi-grad hooks firing each bucket's program during the backward) and the
staged post-backward dispatch bit-identical to the barrier sync, with the
buckets fired head first; and ``Communicator.all_reduce_with_error``
against the JAX package's on a ``pods=2`` cube within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.overlap import bucket_leaf_indices as jax_buckets
from repro.testing import substrate

from repro_torch.core.comm import CommTrace
from repro_torch.core.hypercube import Hypercube
from repro_torch.models.params import flat_leaves
from repro_torch.runtime.overlap import (
    BackwardBucketSync, bucket_leaf_indices,
    sync_replicated_grads_overlapped, with_backward_bucket_sync)
from repro_torch.runtime.trainer import (
    replication_dims, sync_replicated_grads)

EF_TOL = 1e-6


@pytest.mark.parametrize("tree", [
    {"embed": 0, "final_norm": 0, "lm_head": 0,
     "units": {"b": 0, "w": 0}},
    {"mystery": 0, "lm_head": 0},
    {"embed": 0, "units": {"p0": {"ln": 0, "wq": 0}, "p1": {"fln": 0}},
     "final_norm": 0, "enc_units": {"p0": {"x": 0}}, "frontend_proj": 0},
])
def test_bucket_leaf_indices_match_jax(tree):
    assert bucket_leaf_indices(tree) == jax_buckets(tree)


def test_bucket_leaf_indices_reverse_layer_order():
    params = {"embed": 0, "final_norm": 0, "lm_head": 0,
              "units": {"b": 0, "w": 0}}
    assert bucket_leaf_indices(params) == [[1, 2], [3, 4], [0]]


def _cube():
    return Hypercube.build({"pod": 2, "dp": 2, "tp": 2}, pods=2)


def _toy(cube):
    """Toy per-step view leaves on the pod cube: embed fully sharded (no
    sync), units sharded over tp only, head / norm fully replicated."""
    d = cube.dim_names
    specs = {"embed": (d, None), "final_norm": (None,),
             "lm_head": (None, None),
             "units": {"b": (d[-1],), "w": (d[-1], None)}}
    local = {"embed": (1, 4), "final_norm": (4,), "lm_head": (4, 2),
             "units": {"b": (1,), "w": (1, 4)}}
    gen = torch.Generator().manual_seed(0)
    params = {}
    for k, v in local.items():
        if isinstance(v, dict):
            params[k] = {kk: torch.randn(cube.dim_sizes + vv, generator=gen)
                         .requires_grad_() for kk, vv in v.items()}
        else:
            params[k] = torch.randn(cube.dim_sizes + v, generator=gen
                                    ).requires_grad_()
    return params, specs


def _loss(params, batch):
    # each PE's own use of its parameters, in forward-production order
    h = (params["embed"].square().sum() + 0.0 * batch.sum()
         + params["units"]["w"].square().sum()
         + params["units"]["b"].square().sum()
         + params["final_norm"].square().sum()
         + params["lm_head"].pow(3).sum())
    return h, {}


def test_hooked_backward_sync_bit_identical_and_ordered():
    cube = _cube()
    params, specs = _toy(cube)
    batch = torch.ones(4)
    (loss, _), _ = _loss(params, batch), None
    loss.backward()
    barrier = sync_replicated_grads(
        {k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict)
             else v.grad) for k, v in params.items()}, specs, cube)
    for p in flat_leaves(params):
        p.grad = None
    hooked_fn = with_backward_bucket_sync(_loss, specs, cube)
    with CommTrace() as tr:
        (loss, _), sync = hooked_fn(params, batch)
        loss.backward()
    hooked = sync.grads()
    for a, b in zip(flat_leaves(barrier), flat_leaves(hooked)):
        assert torch.equal(a, b)
    assert sync.fired == ["grad-sync-b0", "grad-sync-b1"]
    pids = [e.program_id for e in tr.events
            if e.program_id and e.program_id.startswith("grad-sync-b")]
    assert set(pids) == {"grad-sync-b0", "grad-sync-b1"}
    assert pids == sorted(pids), f"bucket dispatch out of order: {pids}"
    # the replicated leaves were summed over their replication dims
    for g, p, s in zip(flat_leaves(hooked), flat_leaves(params),
                       flat_leaves(specs)):
        dims = replication_dims(s, cube)
        if dims:
            axes = tuple(cube.dim_names.index(d) for d in dims)
            assert torch.allclose(g, p.grad.sum(axes, keepdim=True)
                                  .expand_as(g))


def test_hooks_must_all_fire():
    cube = _cube()
    params, specs = _toy(cube)
    sync = BackwardBucketSync(params, specs, cube)
    with pytest.raises(RuntimeError, match="buckets"):
        sync.grads()


def test_post_backward_bucketed_dispatch_order_and_identity():
    cube = _cube()
    params, specs = _toy(cube)
    grads = {k: ({kk: vv.detach() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.detach())
             for k, v in params.items()}
    with CommTrace() as tr:
        got = sync_replicated_grads_overlapped(grads, specs, cube)
    want = sync_replicated_grads(grads, specs, cube)
    for a, b in zip(flat_leaves(want), flat_leaves(got)):
        assert torch.equal(a, b)
    pids = [e.program_id for e in tr.events
            if e.program_id and e.program_id.startswith("grad-sync-b")]
    assert pids == sorted(pids) and len(set(pids)) >= 2


@pytest.mark.parametrize("dims", [("pod", "dp"), ("pod",),
                                  ("pod", "dp", "tp")])
def test_all_reduce_with_error_matches_jax(dims):
    """Two steps of error feedback: the second folds the first's error in.
    Both packages on the ``pod2x2x2`` cube (JAX under shard_map)."""
    jcube = substrate.build_cube("pod2x2x2")
    cube = Hypercube.build({"pod": 2, "dp": 2, "tp": 2}, pods=2)
    n = 700
    x = (np.random.RandomState(7).randn(2, 2, 2, n) * 3).astype(np.float32)

    def jax_step(xs, errs=None):
        def fn(v):
            if errs is None:
                full, err = jcube.comm(dims).all_reduce_with_error(v)
            else:
                full, err = jcube.comm(dims).all_reduce_with_error(
                    v[..., 0, :], error=v[..., 1, :])
            return jnp.stack([full, err], axis=-2)
        arg = xs if errs is None else np.stack([xs, errs], axis=-2)
        out = substrate.run_per_shard(jcube, fn, arg, out_payload_ndim=2)
        return out[..., 0, :], out[..., 1, :]

    jf, je = jax_step(x)
    jf2, je2 = jax_step(x, je)
    c = cube.comm(dims)
    f, e = c.all_reduce_with_error(torch.from_numpy(x))
    f2, e2 = c.all_reduce_with_error(torch.from_numpy(x), error=e)
    # both outputs against the summed payload's scale (the error term
    # inherits the rounding of the ICI reduce-scatter's sums)
    for got, want, full in ((f, jf, jf), (e, je, jf), (f2, jf2, jf2),
                            (e2, je2, jf2)):
        assert np.abs(got.numpy() - want).max() <= EF_TOL * max(
            1.0, np.abs(full).max())
    with pytest.raises(ValueError, match="DCN"):
        cube.comm(("dp", "tp")).all_reduce_with_error(torch.from_numpy(x))
