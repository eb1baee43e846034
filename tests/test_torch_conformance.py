"""Conformance of the port's collective layer: every (primitive x registered
flow x dim selection) cell, counterpart of ``tests/test_conformance.py``.

Each cell runs the port's collective on the in-process cube and compares it
with the independent NumPy oracles of ``repro.testing.oracles``. Reduction
payloads are integer-valued, so every flow -- the Table II stages, the
§IX-A ``hierarchical`` split, the Fig. 23(a) ``ring`` / ``tree``
comparators and the fused ring flows -- must match the oracle bit for bit;
the lossy §V-C ``compressed`` flow is held within its quantization bound.
Selections: the 8-PE cells of the reference (``ring8``, ``2x4`` with
``01``, ``2x2x2`` with ``010`` / ``110`` / ``011``) and the 16-PE
``CUBE_SPECS`` shapes (``4d16``, ``ring16``, ``pod2x4x2``). The meta-tests
read the parametrize marks, so a dropped sweep of any registered flow
fails the accounting.
"""

import numpy as np
import pytest
import torch

from repro.core import comm as jax_comm
from repro.testing import oracles
from repro.testing.substrate import integer_payload

from repro_torch.core import comm as C
from repro_torch.core.comm import CommTrace, applicability, resolve_stage
from repro_torch.core.hypercube import Hypercube
from repro_torch.kernels.collective import FUSED_ENTRIES

APPLICABILITY = applicability()

CUBES = {
    "ring8": ({"d": 8}, 1),
    "2x4": ({"r": 2, "c": 4}, 1),
    "2x2x2": ({"a": 2, "b": 2, "c": 2}, 1),
    "pod2x2x2": ({"pod": 2, "dp": 2, "tp": 2}, 2),
    "4d16": ({"w": 2, "x": 2, "y": 2, "z": 2}, 1),
    "ring16": ({"d": 16}, 1),
    "pod2x4x2": ({"pod": 2, "dp": 4, "tp": 2}, 2),
}
SELECTIONS = [
    ("ring8", "1"),
    ("2x4", "01"),
    ("2x2x2", "010"),
    ("2x2x2", "110"),
    ("2x2x2", "011"),
    ("4d16", "1100"),
    ("4d16", "0110"),
    ("4d16", "1010"),
    ("4d16", "1111"),
    ("ring16", "1"),
    ("pod2x4x2", "110"),
    ("pod2x4x2", "011"),
    ("pod2x4x2", "100"),
]
# DCN-crossing selections: where the hierarchical and compressed flows split
POD_SELECTIONS = [("pod2x2x2", "110"), ("pod2x2x2", "100"),
                  ("pod2x4x2", "110"), ("pod2x4x2", "100"),
                  ("pod2x4x2", "111")]


def _cube(name):
    dims, pods = CUBES[name]
    return Hypercube.build(dims, pods=pods)


def _sel(cube, bitmap):
    names = cube.dims_from_bitmap(bitmap)
    return names, tuple(cube.dim_names.index(d) for d in names)


def _stages(primitive):
    return APPLICABILITY[primitive] + ("pidcomm",)


def _cells(primitive):
    return [(cn, bm, st) for cn, bm in SELECTIONS
            for st in _stages(primitive)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- PE <-> PE
@pytest.mark.parametrize("cube_name,bitmap,stage", _cells("all_reduce"))
def test_all_reduce_conformance(cube_name, bitmap, stage):
    cube = _cube(cube_name)
    names, idx = _sel(cube, bitmap)
    x = integer_payload(cube, (3, 5), seed=cube.ndim)
    got = cube.comm(names).all_reduce(_t(x), algorithm=stage).numpy()
    np.testing.assert_array_equal(got, oracles.all_reduce(x, cube.ndim, idx))


@pytest.mark.parametrize("op", ["add", "min"])
@pytest.mark.parametrize("cube_name,bitmap,stage", _cells("reduce_scatter"))
def test_reduce_scatter_conformance(cube_name, bitmap, stage, op):
    cube = _cube(cube_name)
    names, idx = _sel(cube, bitmap)
    g = cube.group_size(names)
    x = integer_payload(cube, (2, 8 * g), seed=g)
    got = cube.comm(names).reduce_scatter(_t(x), axis=1, op=op,
                                          algorithm=stage).numpy()
    np.testing.assert_array_equal(
        got, oracles.reduce_scatter(x, cube.ndim, idx, axis=1, op=op))


@pytest.mark.parametrize("cube_name,bitmap,stage", _cells("all_gather"))
def test_all_gather_conformance(cube_name, bitmap, stage):
    cube = _cube(cube_name)
    names, idx = _sel(cube, bitmap)
    rng = np.random.RandomState(7)
    x = rng.randn(*(cube.dim_sizes + (3, 4))).astype(np.float32)
    got = cube.comm(names).all_gather(_t(x), axis=0,
                                      algorithm=stage).numpy()
    np.testing.assert_array_equal(got, oracles.all_gather(x, cube.ndim, idx,
                                                          axis=0))


@pytest.mark.parametrize("cube_name,bitmap,stage", _cells("all_to_all"))
def test_all_to_all_conformance(cube_name, bitmap, stage):
    cube = _cube(cube_name)
    names, idx = _sel(cube, bitmap)
    g = cube.group_size(names)
    rng = np.random.RandomState(g)
    x = rng.randn(*(cube.dim_sizes + (2, 4 * g))).astype(np.float32)
    got = cube.comm(names).all_to_all(_t(x), split_axis=1, concat_axis=1,
                                      algorithm=stage).numpy()
    np.testing.assert_array_equal(
        got, oracles.all_to_all(x, cube.ndim, idx, split_axis=1,
                                concat_axis=1))


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("stage", _stages("all_reduce"))
def test_all_reduce_nonadd_ops(op, stage):
    cube = _cube("ring8")
    x = integer_payload(cube, (6,), seed=11)
    got = cube.comm("d").all_reduce(_t(x), op=op, algorithm=stage).numpy()
    np.testing.assert_array_equal(got, oracles.all_reduce(x, 1, (0,), op=op))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
def test_dtype_sweep(dtype):
    """pidcomm all_reduce and all_to_all across payload dtypes."""
    cube = _cube("ring8")
    comm = cube.comm("d")
    x = integer_payload(cube, (16,), seed=3)
    t = _t(x).to(dtype)
    np.testing.assert_array_equal(
        comm.all_reduce(t, algorithm="pidcomm").double().numpy(),
        oracles.all_reduce(x.astype(np.float64), 1, (0,)))
    np.testing.assert_array_equal(
        comm.all_to_all(t, split_axis=0, concat_axis=0,
                        algorithm="pidcomm").double().numpy(),
        oracles.all_to_all(x.astype(np.float64), 1, (0,), split_axis=0,
                           concat_axis=0))


# ------------------------------------------------ the non-stage all_reduces
# hierarchical (falls back to the direct flow off the pod boundary) and tree
# run on every selection; ring on the single-dim ones (the reference's
# contract: "ring all_reduce runs on a single dim")
_NON_STAGE_CELLS = [(cn, bm, alg) for cn, bm in SELECTIONS
                    for alg in ("hierarchical", "tree")
                    ] + [(cn, bm, "ring") for cn, bm in SELECTIONS
                         if bm.count("1") == 1]


@pytest.mark.parametrize("cube_name,bitmap,alg", _NON_STAGE_CELLS)
def test_non_stage_all_reduce_conformance(cube_name, bitmap, alg):
    cube = _cube(cube_name)
    names, idx = _sel(cube, bitmap)
    # a first axis off the group size: ring pads its chunks
    x = integer_payload(cube, (5, 3), seed=cube.ndim + 1)
    with CommTrace() as tr:
        got = cube.comm(names).all_reduce(_t(x), algorithm=alg).numpy()
    np.testing.assert_array_equal(got, oracles.all_reduce(x, cube.ndim, idx))
    assert [e.flow for e in tr.events] == [alg]
    assert tr.events[0].stage == "im"


@pytest.mark.parametrize("alg", ["ring", "tree", "ring_fused",
                                 "rs_epilogue"])
def test_float_payloads_against_jax(alg):
    """Random f32 on ring8 against the JAX flow under shard_map: tree,
    ring_fused and rs_epilogue bit for bit; ring within 1e-6 x max(1,
    max|ref|) -- XLA on the CPU evaluates the reference's ring as the
    member-order sum (4.8e-7 from the ring-order one here)."""
    from repro.testing import substrate
    jcube = substrate.build_cube("ring8")
    x = np.random.RandomState(0).randn(8, 16, 3).astype(np.float32)
    comm = _cube("ring8").comm("d")
    jcomm = jcube.comm("d")
    if alg == "rs_epilogue":
        got = comm.reduce_scatter(_t(x), axis=0, algorithm=alg)
        want = substrate.run_per_shard(
            jcube, lambda v: jcomm.reduce_scatter(v, axis=1, algorithm=alg),
            x)
    elif alg == "ring_fused":
        got = comm.all_gather(_t(x), axis=0, algorithm=alg)
        want = substrate.run_per_shard(
            jcube, lambda v: jcomm.all_gather(v, axis=1, algorithm=alg), x)
    else:
        got = comm.all_reduce(_t(x), algorithm=alg)
        want = substrate.run_per_shard(
            jcube, lambda v: jcomm.all_reduce(v, algorithm=alg), x)
    got = got.numpy()
    if alg == "ring":
        assert np.abs(got - want).max() <= 1e-6 * max(1.0,
                                                      np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


def test_ring_and_tree_reject_what_the_reference_rejects():
    cube = _cube("2x2x2")
    x = _t(integer_payload(cube, (4,)))
    with pytest.raises(ValueError, match="single dim"):
        cube.comm("110").all_reduce(x, algorithm="ring")
    for alg in ("ring", "tree", "compressed"):
        with pytest.raises(ValueError, match="add"):
            cube.comm("010").all_reduce(x, op="max", algorithm=alg)
    odd = Hypercube.build({"a": 3, "b": 2})
    with pytest.raises(ValueError, match="power-of-two"):
        odd.comm("10").all_reduce(_t(integer_payload(odd, (4,))),
                                  algorithm="tree")
    with pytest.raises(ValueError, match="DCN"):
        cube.comm("010").all_reduce(x, algorithm="compressed")


@pytest.mark.parametrize("cube_name,bitmap", POD_SELECTIONS)
def test_compressed_all_reduce_conformance(cube_name, bitmap):
    """The §V-C flow is lossy: within one quantization step per pod of the
    oracle (each pod's ICI-reduced shard rounds to int8 by blocks, step =
    block absmax / 127, at most half a step each)."""
    cube = _cube(cube_name)
    names, idx = _sel(cube, bitmap)
    fast, slow = cube.split_fast_slow(names)
    x = integer_payload(cube, (40, 9), seed=5).astype(np.float32)
    x *= np.random.RandomState(5).rand(*x.shape).astype(np.float32)
    with CommTrace() as tr:
        got = cube.comm(names).all_reduce(_t(x),
                                          algorithm="compressed").numpy()
    want = oracles.all_reduce(x, cube.ndim, idx)
    pod_sums = oracles.all_reduce(
        x, cube.ndim, [cube.dim_names.index(d) for d in fast]) if fast \
        else x
    gs = cube.group_size(slow)
    step = np.abs(pod_sums).max() / 127.0
    assert np.abs(got - want).max() <= gs * step
    # and lossy: a flow that skipped the int8 hop would land on the oracle
    assert np.abs(got - want).max() > 1e-6 * np.abs(want).max()
    assert [e.flow for e in tr.events] == ["compressed"]
    assert tr.events[0].stage == "cm" and tr.events[0].dcn_bytes > 0


# ---------------------------------------------------- collective-fused flows
# The registered fused ring flows dispatched by name through the same
# Communicator entry points at every selection: ring_fused / ag_prologue
# are pure movement here (no consumer / identity block_fn), rs_epilogue's
# ring sum is exact on integer-valued payloads.
@pytest.mark.parametrize("alg", ["ring_fused", "ag_prologue"])
@pytest.mark.parametrize("cube_name,bitmap", SELECTIONS)
def test_fused_all_gather_conformance(cube_name, bitmap, alg):
    cube = _cube(cube_name)
    names, idx = _sel(cube, bitmap)
    rng = np.random.RandomState(17)
    x = rng.randn(*(cube.dim_sizes + (3, 4))).astype(np.float32)
    got = cube.comm(names).all_gather(_t(x), axis=0, algorithm=alg).numpy()
    np.testing.assert_array_equal(got, oracles.all_gather(x, cube.ndim, idx,
                                                          axis=0))


@pytest.mark.parametrize("op", ["add", "min"])
@pytest.mark.parametrize("alg", ["rs_epilogue"])
@pytest.mark.parametrize("cube_name,bitmap", SELECTIONS)
def test_fused_reduce_scatter_conformance(cube_name, bitmap, alg, op):
    cube = _cube(cube_name)
    names, idx = _sel(cube, bitmap)
    g = cube.group_size(names)
    x = integer_payload(cube, (2, 8 * g), seed=g)
    got = cube.comm(names).reduce_scatter(_t(x), axis=1, op=op,
                                          algorithm=alg).numpy()
    np.testing.assert_array_equal(
        got, oracles.reduce_scatter(x, cube.ndim, idx, axis=1, op=op))


# -------------------------------------------------------- stage escalation
def test_ladder_max_fallthrough(monkeypatch):
    """An im all_to_all past _LADDER_MAX members falls through to cm and
    still matches the oracle."""
    monkeypatch.setattr(C, "_LADDER_MAX", 2)
    cube = _cube("ring8")
    x = np.random.RandomState(0).randn(8, 2, 16).astype(np.float32)
    with CommTrace() as tr:
        got = cube.comm("d").all_to_all(_t(x), split_axis=1, concat_axis=1,
                                        algorithm="im").numpy()
    assert [e.flow for e in tr.events] == ["cm"]
    np.testing.assert_array_equal(
        got, oracles.all_to_all(x, 1, (0,), split_axis=1, concat_axis=1))


def test_stage_resolution_table_ii():
    """An inapplicable stage falls back to the strongest applicable one at
    or below the request; pidcomm takes the ladder top."""
    assert resolve_stage("reduce_scatter", "cm") == "im"
    assert resolve_stage("scatter", "pr") == "naive"
    assert resolve_stage("scatter", "cm") == "im"
    assert resolve_stage("broadcast", "cm") == "naive"
    for prim, stages in APPLICABILITY.items():
        assert resolve_stage(prim, "pidcomm") == stages[-1]
        for st in stages:
            assert resolve_stage(prim, st) == st
        with pytest.raises(ValueError):
            resolve_stage(prim, "warp")


def test_registry_matches_jax():
    """Every primitive's registered flows (in registration order) and the
    derived Table II equal the JAX package's: the non-Table-II entries do
    not widen the paper's rows."""
    for prim in C.PRIMITIVES:
        assert C.registered_algorithms(prim) == \
            jax_comm.registered_algorithms(prim), prim
        for name in C.registered_algorithms(prim):
            mine, ref = C.get_algorithm(prim, name), jax_comm.get_algorithm(
                prim, name)
            assert (mine.stage, mine.table_ii) == (ref.stage, ref.table_ii)
    assert C.applicability() == jax_comm.applicability()
    with pytest.raises(ValueError, match="explicit stage"):
        C.register_algorithm("all_reduce", "warp")
    with pytest.raises(ValueError, match="already registered"):
        C.register_algorithm("all_reduce", "ring", stage="im")(lambda *a: a)


# ------------------------------------------------------- hierarchical IX-A
def test_hierarchical_all_reduce_dcn():
    """Pod-crossing im all_reduce on ("pod", "dp"): oracle agreement, and
    the dispatch takes the §IX-A split (ICI reduce-scatter, DCN all-reduce
    of the 1/|ICI| shard, ICI all-gather) with its DCN bytes."""
    cube = _cube("pod2x2x2")
    assert cube.dcn_dims == ("pod",)
    comm = cube.comm(("pod", "dp"))
    x = integer_payload(cube, (5,), seed=9)
    with CommTrace() as tr:
        got = comm.all_reduce(_t(x), algorithm="im").numpy()
    np.testing.assert_array_equal(got, oracles.all_reduce(x, 3, (0, 1)))
    ev = tr.events[0]
    assert (ev.flow, ev.stage) == ("hierarchical", "im")
    assert ev.dcn_bytes == pytest.approx(2 * (5 * 4 / 2) * (1 / 2))


@pytest.mark.parametrize("alg", ["im", "auto", "pidcomm", "hierarchical"])
@pytest.mark.parametrize("dims", [("pod", "dp"), ("pod", "dp", "tp")])
def test_pod_crossing_all_reduce_runs_the_split(alg, dims):
    """The pod-crossing all_reduce on pod2x4x2 under every request that
    resolves to the §IX-A split: bit-identical to the oracle, the split's
    flow in the trace (it raised before the split was ported)."""
    cube = _cube("pod2x4x2")
    comm = cube.comm(dims)
    x = integer_payload(cube, (5,), seed=13)
    with CommTrace() as tr:
        got = comm.all_reduce(_t(x), algorithm=alg).numpy()
    idx = tuple(cube.dim_names.index(d) for d in dims)
    np.testing.assert_array_equal(got, oracles.all_reduce(x, 3, idx))
    assert [e.flow for e in tr.events] == ["hierarchical"]


@pytest.mark.parametrize("stage", _stages("all_reduce") + ("auto",))
@pytest.mark.parametrize("cube_name", ["pod2x2x2", "pod2x4x2"])
def test_pod_crossing_stage_sweep(cube_name, stage):
    """Every all_reduce stage agrees on the DCN-crossing "110" group."""
    cube = _cube(cube_name)
    names, idx = _sel(cube, "110")
    x = integer_payload(cube, (4,), seed=13)
    got = cube.comm(names).all_reduce(_t(x), algorithm=stage).numpy()
    np.testing.assert_array_equal(got, oracles.all_reduce(x, 3, idx))


def test_hierarchical_keeps_non_additive_and_intra_pod_direct():
    cube = _cube("pod2x4x2")
    x = integer_payload(cube, (6,), seed=2)
    for dims, op in ((("pod", "dp"), "max"), (("dp", "tp"), "add")):
        idx = tuple(cube.dim_names.index(d) for d in dims)
        got = cube.comm(dims).all_reduce(_t(x), op=op,
                                         algorithm="hierarchical").numpy()
        np.testing.assert_array_equal(got, oracles.all_reduce(x, 3, idx, op))


# ------------------------------------------------------------- rooted four
@pytest.mark.parametrize("stage", _stages("scatter"))
@pytest.mark.parametrize("bitmap", ["111", "010"])
def test_scatter_conformance(bitmap, stage):
    cube = _cube("2x2x2")
    names, idx = _sel(cube, bitmap)
    g = cube.group_size(names)
    host = np.random.RandomState(5).randn(4 * g, 3).astype(np.float32)
    got = cube.comm(names).scatter(host, axis=0, algorithm=stage).numpy()
    np.testing.assert_array_equal(
        got, oracles.scatter(host, cube.dim_sizes, idx, axis=0))


@pytest.mark.parametrize("stage", _stages("gather"))
def test_gather_conformance(stage):
    cube = _cube("2x2x2")
    names, idx = _sel(cube, "111")
    comm = cube.comm(names)
    host = np.random.RandomState(6).randn(16, 3).astype(np.float32)
    dev = comm.scatter(host, axis=0)
    back = comm.gather(dev, axis=0, algorithm=stage)
    np.testing.assert_array_equal(back.numpy(), host)
    np.testing.assert_array_equal(oracles.gather(dev.numpy(), 3, idx,
                                                 axis=0), host)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("stage", _stages("reduce"))
def test_reduce_conformance(op, stage):
    cube = _cube("2x2x2")
    comm = cube.comm(("a", "b", "c"))
    host = integer_payload(cube, (), seed=8).reshape(8, 1)
    host = np.concatenate([host] * 4, axis=1).astype(np.float32)
    dev = comm.scatter(host, axis=0)
    got = comm.reduce(dev, op=op, axis=0, algorithm=stage)
    np.testing.assert_array_equal(got.numpy(),
                                  oracles.reduce(host, axis=0, op=op))


@pytest.mark.parametrize("stage", _stages("broadcast"))
def test_broadcast_conformance(stage):
    cube = _cube("2x2x2")
    host = np.random.RandomState(9).randn(6, 2).astype(np.float32)
    got = cube.comm(("a", "b", "c")).broadcast(host, algorithm=stage)
    np.testing.assert_array_equal(got.numpy(),
                                  oracles.broadcast(host, cube.dim_sizes))


def test_reference_shim_cells_through_comm():
    """The cells the reference runs through its deprecated ``Collectives``
    shim (which the port leaves out: ``cube.comm(dims)`` is its one
    surface), run through the communicator: per-call bitmaps, and the
    ring / tree all_reduce wrappers as ``algorithm=``."""
    cube = _cube("2x2x2")
    x = integer_payload(cube, (4, 8), seed=4)
    np.testing.assert_array_equal(
        cube.comm("110").all_reduce(_t(x), algorithm="pidcomm").numpy(),
        oracles.all_reduce(x, 3, (0, 1)))
    np.testing.assert_array_equal(
        cube.comm("011").reduce_scatter(_t(x), axis=1,
                                        algorithm="pidcomm").numpy(),
        oracles.reduce_scatter(x, 3, (1, 2), axis=1))
    ring = _cube("ring8")
    y = integer_payload(ring, (9,), seed=1)
    want = oracles.all_reduce(y, 1, (0,))
    for alg in ("ring", "tree"):
        np.testing.assert_array_equal(
            ring.comm("d").all_reduce(_t(y), algorithm=alg).numpy(), want)


# ----------------------------------------------------- coverage accounting
# Which tests carry each primitive's sweep. The meta-tests read the
# parametrize marks off these functions, so deleting a test or shrinking
# its parametrization fails the accounting.
_CELL_TESTS = {
    "all_reduce": (test_all_reduce_conformance,
                   test_non_stage_all_reduce_conformance),
    "reduce_scatter": (test_reduce_scatter_conformance,
                       test_fused_reduce_scatter_conformance),
    "all_gather": (test_all_gather_conformance,
                   test_fused_all_gather_conformance),
    "all_to_all": (test_all_to_all_conformance,),
    "scatter": (test_scatter_conformance,),
    "gather": (test_gather_conformance,),
    "reduce": (test_reduce_conformance,),
    "broadcast": (test_broadcast_conformance,),
}


def _swept_params(test_fn, name):
    """Values a parametrize mark sweeps for argument ``name``."""
    vals = set()
    for mark in getattr(test_fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        if name not in names:
            continue
        i = names.index(name)
        for val in mark.args[1]:
            vals.add(val[i] if isinstance(val, tuple) else val)
    return vals


def _swept_cells(test_fn):
    """(cube_name, bitmap) pairs in a test function's parametrize marks."""
    cells = set()
    for mark in getattr(test_fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        if names[:2] == ["cube_name", "bitmap"]:
            cells.update(tuple(v[:2]) for v in mark.args[1])
    return cells


def test_every_table_ii_cell_is_swept():
    """Every (primitive, applicable stage) cell of Table II, and the
    pidcomm alias, is attached to a collected conformance sweep."""
    for prim, stages in APPLICABILITY.items():
        swept = _swept_params(_CELL_TESTS[prim][0], "stage")
        assert set(stages) <= swept, (
            f"unswept stages for {prim}: {set(stages) - swept}")
        assert "pidcomm" in swept, f"pidcomm alias unswept for {prim}"


def test_every_registered_flow_is_swept():
    """Every registered flow of every primitive -- the Table II stages,
    hierarchical / ring / tree / compressed, and the FUSED_ENTRIES -- is
    swept by a conformance test, the fused ones at every selection."""
    extra = {"all_reduce": {"compressed": test_compressed_all_reduce_conformance}}
    for prim in C.PRIMITIVES:
        swept = set()
        for fn in _CELL_TESTS[prim]:
            swept |= _swept_params(fn, "stage") | _swept_params(fn, "alg")
        swept |= set(extra.get(prim, {}))
        missing = set(C.registered_algorithms(prim)) - swept
        assert not missing, f"unswept flows of {prim}: {missing}"
    assert _swept_cells(test_compressed_all_reduce_conformance) == set(
        POD_SELECTIONS)
    fused_tests = {"all_gather": test_fused_all_gather_conformance,
                   "reduce_scatter": test_fused_reduce_scatter_conformance}
    assert {(p, a) for p, a, _ in FUSED_ENTRIES} == {
        (p, a) for p in C.PRIMITIVES for a in C.registered_algorithms(p)
        if not C.get_algorithm(p, a).table_ii
        and C.get_algorithm(p, a).stage == "cm" and a != "compressed"}
    for prim, alg, _bit_identical in FUSED_ENTRIES:
        fn = fused_tests[prim]
        assert alg in _swept_params(fn, "alg"), (
            f"unswept fused flow {prim}/{alg}")
        missing = set(SELECTIONS) - _swept_cells(fn)
        assert not missing, f"fused {prim} sweep missing cells: {missing}"
