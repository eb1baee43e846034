"""The port's in-process hypercube and planner held against the JAX
package's: the ``tests/test_hypercube.py`` cases against JAX ``fake_cube``
(same ``dcn_dims``, selections and errors), the cube placement against the
NumPy reshard oracle, and the planner's ``auto`` picks against
``repro.core.planner.plan`` for every cube and size below."""
import math

import numpy as np
import pytest
import torch

from repro.core import planner as jax_planner
from repro.testing import oracles
from repro.testing.substrate import fake_cube

from repro_torch.core import planner
from repro_torch.core.hypercube import Hypercube

# (physical shape, physical axis names, logical dims)
CUBES = [
    ((16, 16), ("data", "model"), {"d0": 256}),
    ((16, 16), ("data", "model"), {"d0": 2, "d1": 128}),
    ((16, 16), ("data", "model"), {"d0": 16, "d1": 16}),
    ((16, 16), ("data", "model"), {"d0": 4, "d1": 8, "d2": 8}),
    ((16, 16), ("data", "model"), {"d0": 2, "d1": 2, "d2": 2, "d3": 32}),
    ((2, 16, 16), ("pod", "data", "model"), {"pod": 2, "dp": 16, "tp": 16}),
    ((2, 2, 2), ("pod", "data", "model"), {"pod": 2, "dp": 2, "tp": 2}),
    ((2, 4, 2), ("pod", "data", "model"), {"pod": 2, "dp": 4, "tp": 2}),
    ((8,), ("d",), {"d": 8}),
    ((2, 4), ("data", "model"), {"r": 2, "c": 4}),
    ((2, 2, 2), ("a", "b", "c"), {"a": 2, "b": 2, "c": 2}),
    ((12, 16), ("data", "model"), {"a": 12, "b": 16}),
]


def _pods(shape, names):
    return math.prod(s for s, n in zip(shape, names) if n == "pod")


def _both(shape, names, dims):
    return fake_cube(shape, names, dims), Hypercube.build(
        dims, pods=_pods(shape, names))


def _selections(cube):
    n = len(cube.dim_names)
    out = []
    for mask in range(1, 2 ** n):
        out.append("".join("1" if mask >> (n - 1 - i) & 1 else "0"
                           for i in range(n)))
    return out


@pytest.mark.parametrize("shape,names,dims", CUBES)
def test_cube_matches_jax(shape, names, dims):
    jcube, cube = _both(shape, names, dims)
    assert cube.dim_names == jcube.dim_names
    assert cube.dim_sizes == jcube.dim_sizes
    assert cube.dcn_dims == jcube.dcn_dims
    assert cube.ndev == jcube.ndev
    assert cube.describe() == jcube.describe()
    for bm in _selections(cube):
        sel = cube.dims_from_bitmap(bm)
        assert sel == jcube.dims_from_bitmap(bm)
        assert cube.group_size(sel) == jcube.group_size(sel)
        assert cube.num_instances(sel) == jcube.num_instances(sel)
        assert cube.split_fast_slow(sel) == jcube.split_fast_slow(sel)
        assert cube.group_size(sel) * cube.num_instances(sel) == cube.ndev
        assert cube.resolve_dims(list(reversed(sel))) == sel


def test_pod_boundary_rule():
    with pytest.raises(ValueError, match="pod boundary"):
        fake_cube((2, 16, 16), ("pod", "data", "model"), {"a": 4, "b": 128})
    with pytest.raises(ValueError, match="pod boundary"):
        Hypercube.build({"a": 4, "b": 128}, pods=2)
    jcube, cube = _both((2, 16, 16), ("pod", "data", "model"),
                        {"pod": 2, "dp": 16, "tp": 16})
    assert cube.dcn_dims == jcube.dcn_dims == ("pod",)
    assert cube.split_fast_slow(("pod", "dp")) == (("dp",), ("pod",))
    # a dim named "pod" sets the pod count when none is given
    assert Hypercube.build({"pod": 2, "dp": 16, "tp": 16}) == cube


def test_power_of_two_rule():
    for build in (lambda d: fake_cube((12, 16), ("data", "model"), d),
                  lambda d: Hypercube.build(d)):
        with pytest.raises(ValueError, match="power of two"):
            build({"a": 16, "b": 12})
        assert build({"a": 12, "b": 16}).ndev == 192


def test_selection_errors():
    jcube, cube = _both((2, 4), ("data", "model"), {"r": 2, "c": 4})
    for bad in ("00", "012", "x"):
        for c in (cube, jcube):
            with pytest.raises(ValueError):
                c.resolve_dims(bad)
    for c in (cube, jcube):
        with pytest.raises(ValueError, match="unknown dim"):
            c.resolve_dims(("r", "zz"))


@pytest.mark.parametrize("spec", [
    ("r", None), (("r", "c"), None), (None, "c"), ("c", "r"), (None, None),
])
def test_to_cube_places_the_oracle_blocks(spec):
    """``to_cube`` leaves on PE c the block ``oracles.placed_shard`` says a
    NamedSharding with ``spec`` gives it; ``from_cube`` inverts it."""
    cube = Hypercube.build({"r": 2, "c": 4})
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    placed = cube.to_cube(torch.from_numpy(x), spec)
    for coords in np.ndindex(*cube.dim_sizes):
        np.testing.assert_array_equal(
            placed[coords].numpy(),
            oracles.placed_shard(x, cube.dim_sizes, cube.dim_names, spec,
                                 coords))
    np.testing.assert_array_equal(cube.from_cube(placed, spec).numpy(), x)


def test_axis_index_is_cube_major():
    cube = Hypercube.build({"a": 2, "b": 2, "c": 2})
    idx = cube.axis_index(("a", "c"))
    for a, b, c in np.ndindex(2, 2, 2):
        assert idx[a, b, c] == a * 2 + c


SIZES = [64, 4096, 2 ** 20, 64 * 2 ** 20]


@pytest.mark.parametrize("shape,names,dims", CUBES)
@pytest.mark.parametrize("primitive", ["all_reduce", "all_gather",
                                       "reduce_scatter", "all_to_all"])
def test_planner_picks_match_jax(shape, names, dims, primitive):
    """Ranking by (DCN bytes, ICI bytes) picks what the reference's
    seconds-based ``plan`` picks, with the same byte estimates."""
    jcube, cube = _both(shape, names, dims)
    for bm in _selections(cube):
        sel = cube.dims_from_bitmap(bm)
        for size in SIZES:
            want = jax_planner.plan(jcube, primitive, sel, size)
            got = planner.plan(cube, primitive, sel, size)
            assert got.algorithm == want.algorithm, (bm, size)
            assert got.ici_bytes == pytest.approx(want.ici_bytes)
            assert got.dcn_bytes == pytest.approx(want.dcn_bytes)
            assert got.stage == want.stage
            assert got.seconds is None


def test_planner_hierarchical_beats_flat():
    jcube, cube = _both((2, 16, 16), ("pod", "data", "model"),
                        {"pod": 2, "dp": 16, "tp": 16})
    payload = 64 * 2 ** 20
    hier = planner.estimate(cube, "all_reduce", ("pod", "dp"), payload)
    naive = planner.estimate(cube, "all_reduce", ("pod", "dp"), payload,
                             algorithm="naive")
    assert hier.algorithm == "hierarchical"
    assert hier.dcn_bytes < naive.dcn_bytes / 4
    for mine, alg in ((hier, "pidcomm"), (naive, "naive")):
        ref = jax_planner.estimate(jcube, "all_reduce", ("pod", "dp"),
                                   payload, algorithm=alg)
        assert (mine.ici_bytes, mine.dcn_bytes, mine.schedule) == (
            ref.ici_bytes, ref.dcn_bytes, ref.schedule)
