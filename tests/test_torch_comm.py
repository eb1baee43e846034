"""Conformance of the port's ported collectives: every Table II stage of
all_reduce, all_gather, reduce_scatter, all_to_all and the rooted four
(scatter / gather / reduce / broadcast), bit-identical to the NumPy oracles of ``repro.testing.oracles`` on integer-valued payloads (so
every reduction order is exact), on the conformance cubes of the JAX suite:
``ring8``, ``2x4`` with ``01`` and ``2x2x2`` with ``010``/``110``/``011``,
and for all_to_all also the 16-PE shapes ``4d16``, ``ring16`` and
``pod2x4x2``.
"""
import numpy as np
import pytest
import torch

from repro.testing import oracles
from repro.testing.substrate import integer_payload

from repro_torch.core import comm as comm_mod
from repro_torch.core.comm import CommTrace
from repro_torch.core.hypercube import Hypercube

CUBES = {
    "ring8": {"d": 8},
    "2x4": {"r": 2, "c": 4},
    "2x2x2": {"a": 2, "b": 2, "c": 2},
    "4d16": {"w": 2, "x": 2, "y": 2, "z": 2},
    "ring16": {"d": 16},
    "pod2x4x2": {"pod": 2, "dp": 4, "tp": 2},
}
CELLS = [("ring8", "1"), ("2x4", "01"), ("2x2x2", "010"), ("2x2x2", "110"),
         ("2x2x2", "011")]
CELLS16 = [("4d16", "1100"), ("4d16", "0110"), ("4d16", "1010"),
           ("4d16", "1111"), ("ring16", "1"), ("pod2x4x2", "110"),
           ("pod2x4x2", "011"), ("pod2x4x2", "100")]
OPS = ["add", "max", "min"]
PAYLOAD = (8, 8)                 # both axes divisible by every group


def _setup(cube_name, bitmap, seed=0, dtype=np.float32, payload=PAYLOAD):
    cube = Hypercube.build(CUBES[cube_name],
                           pods=2 if cube_name.startswith("pod") else 1)
    x = integer_payload(cube, payload, dtype=dtype, seed=seed)
    axes = [i for i, b in enumerate(bitmap) if b == "1"]
    return cube, cube.comm(bitmap), x, axes


def _run(fn, x):
    out = fn(torch.from_numpy(x))
    return out.numpy()


@pytest.mark.parametrize("cube_name,bitmap", CELLS)
@pytest.mark.parametrize("stage", ["naive", "pr", "im", "auto", "pidcomm"])
@pytest.mark.parametrize("op", OPS)
def test_all_reduce(cube_name, bitmap, stage, op):
    cube, c, x, axes = _setup(cube_name, bitmap)
    got = _run(lambda t: c.all_reduce(t, op=op, algorithm=stage), x)
    np.testing.assert_array_equal(got, oracles.all_reduce(x, cube.ndim, axes,
                                                          op))


@pytest.mark.parametrize("cube_name,bitmap", CELLS)
@pytest.mark.parametrize("stage", ["naive", "pr", "im", "auto", "pidcomm"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_scatter(cube_name, bitmap, stage, op, axis):
    cube, c, x, axes = _setup(cube_name, bitmap, seed=1)
    got = _run(lambda t: c.reduce_scatter(t, axis=axis, op=op,
                                          algorithm=stage), x)
    np.testing.assert_array_equal(
        got, oracles.reduce_scatter(x, cube.ndim, axes, axis=axis, op=op))


@pytest.mark.parametrize("cube_name,bitmap", CELLS)
@pytest.mark.parametrize("stage", ["naive", "pr", "im", "cm", "auto"])
@pytest.mark.parametrize("axis", [0, 1])
def test_all_gather(cube_name, bitmap, stage, axis):
    cube, c, x, axes = _setup(cube_name, bitmap, seed=2)
    got = _run(lambda t: c.all_gather(t, axis=axis, algorithm=stage), x)
    np.testing.assert_array_equal(
        got, oracles.all_gather(x, cube.ndim, axes, axis=axis))


A2A_STAGES = ["naive", "pr", "im", "cm", "auto", "pidcomm"]
# (split_axis, concat_axis): both orders, the same axis, and the MoE
# dispatch / combine pair of a (E, C, D) payload
A2A_AXES = [(0, 1), (1, 0), (0, 0), (1, 1), (2, 2), (1, 2)]
A2A_DTYPES = {"float32": torch.float32, "int32": torch.int32,
              "bfloat16": torch.bfloat16}


def _a2a_case(cube_name, bitmap, seed, dtype):
    """An integer payload (E, C, D) whose first two axes split over the
    group; the oracle runs on its f32 (or int32) copy."""
    cube = Hypercube.build(CUBES[cube_name],
                           pods=2 if cube_name.startswith("pod") else 1)
    g = cube.group_size(cube.dims_from_bitmap(bitmap))
    x = integer_payload(cube, (2 * g, g, 4 * g), seed=seed,
                        dtype=np.int32 if dtype == "int32" else np.float32)
    axes = [i for i, b in enumerate(bitmap) if b == "1"]
    return cube, cube.comm(bitmap), x, axes


@pytest.mark.parametrize("cube_name,bitmap", CELLS + CELLS16)
@pytest.mark.parametrize("stage", A2A_STAGES)
@pytest.mark.parametrize("dtype", sorted(A2A_DTYPES))
def test_all_to_all(cube_name, bitmap, stage, dtype):
    cube, c, x, axes = _a2a_case(cube_name, bitmap, 4, dtype)
    t = torch.from_numpy(x).to(A2A_DTYPES[dtype])
    for sa, ca in A2A_AXES:
        got = c.all_to_all(t, split_axis=sa, concat_axis=ca, algorithm=stage)
        assert got.dtype == t.dtype
        want = oracles.all_to_all(x, cube.ndim, axes, split_axis=sa,
                                  concat_axis=ca)
        np.testing.assert_array_equal(
            got.to(torch.float32 if dtype == "bfloat16" else got.dtype)
            .numpy(), want, err_msg=f"split {sa} concat {ca}")


def test_all_to_all_auto_runs_cm_on_one_kernel_launch(monkeypatch):
    """``auto`` plans the direct flow, which resolves to ``cm``: the whole
    all_to_all across every instance is one reorder call, whose block
    permutation is computed once per request and kept on the device."""
    from repro_torch.kernels.reorder import ops as reorder_ops
    calls = []
    swizzle = reorder_ops.tile_swizzle

    def counting(x, perm, inv=None):
        calls.append((tuple(x.shape), perm.dtype))
        return swizzle(x, perm, inv)

    monkeypatch.setattr(reorder_ops, "tile_swizzle", counting)
    cube, c, x, axes = _a2a_case("2x2x2", "011", 5, "float32")
    t = torch.from_numpy(x)
    with CommTrace() as tr:
        for _ in range(2):
            c.all_to_all(t, split_axis=0, concat_axis=1)
        c.all_to_all(t, split_axis=1, concat_axis=0, algorithm="naive")
    assert [e.flow for e in tr.events] == ["cm", "cm", "naive"]
    assert [e.stage for e in tr.events] == ["cm", "cm", "naive"]
    assert tr.events[0].num_instances == 2 and tr.events[0].group_size == 4
    assert tr.events[0].ici_bytes < tr.events[2].ici_bytes
    # one launch per cm all_to_all over the whole cube tensor (8 PEs x 8
    # experts, units of C * D); naive and im move no block through it
    assert calls == [((64, 4 * 16), torch.int32)] * 2
    assert len(c._perms) == 1
    c.all_to_all(t, split_axis=1, concat_axis=0, algorithm="pr")
    assert len(calls) == 3 and len(c._perms) == 2
    assert comm_mod.applicability()["all_to_all"] == ("naive", "pr", "im",
                                                      "cm")


def test_all_to_all_group_of_one_and_bad_axes():
    cube = Hypercube.build({"a": 1, "b": 4})
    x = torch.from_numpy(integer_payload(cube, (4, 4)))
    assert cube.comm("10").all_to_all(x, split_axis=0, concat_axis=1) is x
    c = cube.comm("01")
    with pytest.raises(ValueError, match="payload"):
        c.all_to_all(x, split_axis=2, concat_axis=0)
    with pytest.raises(ValueError, match="divisible"):
        c.all_to_all(x[..., :3, :], split_axis=0, concat_axis=1)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_integer_and_bf16_payloads(dtype):
    cube, c, x, axes = _setup("2x2x2", "110", seed=3, dtype=dtype)
    t = torch.from_numpy(x)
    want = oracles.all_reduce(x, cube.ndim, axes, "add")
    for stage in ("naive", "pr", "im"):
        np.testing.assert_array_equal(c.all_reduce(t, algorithm=stage)
                                      .numpy(), want)
    got = c.all_gather(t.to(torch.bfloat16), axis=0, algorithm="naive")
    np.testing.assert_array_equal(
        got.float().numpy(), oracles.all_gather(x, cube.ndim, axes, axis=0)
        .astype(np.float32))


def test_results_are_materialized_per_pe():
    """A result may be written by one PE without touching another's copy
    (decode writes caches in place; never into a broadcast view)."""
    cube, c, x, _ = _setup("ring8", "1")
    for out in (c.all_reduce(torch.from_numpy(x)),
                c.all_gather(torch.from_numpy(x), axis=0)):
        before = out[1].clone()
        out[0].fill_(123.0)
        torch.testing.assert_close(out[1], before)


def test_stages_are_distinct_flows_and_traced():
    cube, c, x, _ = _setup("2x4", "01")
    t = torch.from_numpy(x)
    assert comm_mod.applicability()["all_reduce"] == ("naive", "pr", "im")
    assert comm_mod.applicability()["all_gather"] == ("naive", "pr", "im",
                                                      "cm")
    with CommTrace() as tr:
        for stage in ("naive", "pr", "im", "auto"):
            c.all_reduce(t, algorithm=stage)
        c.all_gather(t, axis=0, algorithm="cm")
    flows = [e.flow for e in tr.events]
    assert flows == ["naive", "pr", "im", "im", "cm"]
    assert tr.events[0].stage == "naive" and tr.events[-1].group_size == 4
    assert all(e.seconds is None for e in tr.events)
    assert tr.summary()["events"] == 5


def test_auto_pick_is_cached_per_request():
    cube, c, x, _ = _setup("ring8", "1")
    t = torch.from_numpy(x)
    c.all_reduce(t)
    c.all_reduce(t)
    c.all_reduce(t, op="max")
    assert len(c._flows) == 2


def test_unported_flows_raise():
    """Every flow of the JAX registry is ported now: a flow registered for
    another primitive, or none, raises ValueError; the non-stage
    all_reduce flows run, and a pod-crossing additive all_reduce takes the
    hierarchical split (it raised NotImplementedError before the split was
    ported)."""
    cube, c, x, _ = _setup("ring8", "1")
    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match="unknown algorithm"):
        c.all_to_all(t, split_axis=0, concat_axis=0,
                     algorithm="hierarchical")
    assert {p: comm_mod.applicability()[p] for p in (
        "scatter", "gather", "reduce", "broadcast")} == {
        "scatter": ("naive", "im"), "gather": ("naive", "im"),
        "reduce": ("naive", "pr", "im"), "broadcast": ("naive",)}
    want = oracles.all_reduce(x, 1, [0], "add")
    for flow in ("ring", "tree", "hierarchical"):
        np.testing.assert_array_equal(c.all_reduce(t, algorithm=flow)
                                      .numpy(), want)
    with pytest.raises(ValueError, match="DCN"):
        c.all_reduce(t, algorithm="compressed")
    with pytest.raises(ValueError, match="unknown algorithm"):
        c.all_reduce(t, algorithm="bogus")
    pod = Hypercube.build({"pod": 2, "dp": 2, "tp": 2}, pods=2)
    y = torch.from_numpy(integer_payload(pod, PAYLOAD))
    with CommTrace() as tr:
        got = pod.comm(("pod", "dp")).all_reduce(y)
    assert [e.flow for e in tr.events] == ["hierarchical"]
    np.testing.assert_array_equal(
        got.numpy(), oracles.all_reduce(y.numpy(), 3, [0, 1], "add"))
    np.testing.assert_array_equal(
        pod.comm(("pod", "dp")).all_reduce(y, op="max").numpy(),
        oracles.all_reduce(y.numpy(), 3, [0, 1], "max"))


# ------------------------------------------------------------- rooted four
ROOTED_STAGES = {"scatter": ["naive", "im", "auto", "pidcomm"],
                 "gather": ["naive", "im", "auto", "pidcomm"],
                 "reduce": ["naive", "pr", "im", "auto", "pidcomm"],
                 "broadcast": ["naive", "auto", "pidcomm"]}


def _host(cube_name, bitmap, seed, rows=4, cols=3, dtype=np.float32):
    """An integer host value whose axis 0 splits over the group."""
    cube = Hypercube.build(CUBES[cube_name])
    g = cube.group_size(cube.dims_from_bitmap(bitmap))
    host = np.random.RandomState(seed).randint(-4, 5, (rows * g, cols))
    axes = [i for i, b in enumerate(bitmap) if b == "1"]
    return cube, cube.comm(bitmap), host.astype(dtype), axes


@pytest.mark.parametrize("cube_name,bitmap", CELLS)
@pytest.mark.parametrize("stage", ROOTED_STAGES["scatter"])
@pytest.mark.parametrize("axis", [0, 1])
def test_scatter(cube_name, bitmap, stage, axis):
    cube, c, host, axes = _host(cube_name, bitmap, 5)
    if axis == 1:
        host = np.ascontiguousarray(host.T)
    got = c.scatter(host, axis=axis, algorithm=stage)
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), oracles.scatter(host, cube.dim_sizes, axes, axis=axis))


@pytest.mark.parametrize("cube_name,bitmap", CELLS)
@pytest.mark.parametrize("stage", ROOTED_STAGES["gather"])
def test_gather(cube_name, bitmap, stage):
    cube, c, host, axes = _host(cube_name, bitmap, 6)
    dev = c.scatter(host, axis=0)
    back = c.gather(dev, axis=0, algorithm=stage)
    assert back.device.type == "cpu"
    np.testing.assert_array_equal(back.numpy(), host)
    # the oracle's reassembly from the per-PE blocks agrees
    np.testing.assert_array_equal(
        oracles.gather(dev.numpy(), cube.ndim, axes, axis=0), host)
    # a replicated value gives its single copy back, as a fresh tensor
    rep = c.broadcast(host)
    one = c.gather(rep, spec=(), algorithm=stage)
    np.testing.assert_array_equal(one.numpy(), host)
    one.fill_(0.0)
    assert rep.abs().sum() > 0


@pytest.mark.parametrize("cube_name,bitmap", CELLS)
@pytest.mark.parametrize("stage", ROOTED_STAGES["reduce"])
@pytest.mark.parametrize("op", OPS)
def test_reduce(cube_name, bitmap, stage, op):
    cube, c, host, axes = _host(cube_name, bitmap, 8)
    dev = c.scatter(host, axis=0)
    got = c.reduce(dev, op=op, axis=0, algorithm=stage)
    want = oracles.reduce(host, axis=0, op=op)
    assert got.dtype == dev.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cube_name,bitmap", CELLS)
@pytest.mark.parametrize("stage", ROOTED_STAGES["broadcast"])
def test_broadcast(cube_name, bitmap, stage):
    cube, c, host, _ = _host(cube_name, bitmap, 9)
    got = c.broadcast(host, algorithm=stage)
    np.testing.assert_array_equal(got.numpy(),
                                  oracles.broadcast(host, cube.dim_sizes))
    before = got[(1,) * cube.ndim].clone()
    got[(0,) * cube.ndim].fill_(99.0)           # every PE's own copy
    torch.testing.assert_close(got[(1,) * cube.ndim], before)


def test_rooted_spec_layouts_round_trip():
    """The ``spec`` form places a host value under a whole layout (what a
    per-slot cache row needs) and gather / reduce assemble it back."""
    cube = Hypercube.build(CUBES["2x2x2"])
    c = cube.comm("011")
    host = np.arange(4 * 8 * 2, dtype=np.float32).reshape(4, 8, 2)
    spec = (("a",), ("b", "c"), None)
    dev = c.scatter(host, spec=spec)
    assert dev.shape == (2, 2, 2, 2, 2, 2)
    torch.testing.assert_close(dev, cube.to_cube(torch.from_numpy(host),
                                                 spec))
    np.testing.assert_array_equal(c.gather(dev, spec=spec).numpy(), host)
    np.testing.assert_array_equal(
        c.reduce(dev, op="max", axis=1, spec=spec).numpy(), host.max(1))
    for bad in (lambda: c.scatter(host), lambda: c.gather(dev),
                lambda: c.scatter(host, axis=0, spec=spec),
                lambda: c.gather(dev, axis=0, spec=spec)):
        with pytest.raises(ValueError, match="exactly one"):
            bad()


def test_rooted_auto_dispatch_traced_and_placed():
    cube = Hypercube.build(CUBES["2x2x2"])
    c = cube.comm("111")
    host = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    with CommTrace() as tr:
        dev = c.scatter(host, axis=0)
        c.broadcast(host)
        back = c.gather(dev, axis=0)
        red = c.reduce(dev, op="add", axis=0)
    np.testing.assert_array_equal(back.numpy(), host)
    np.testing.assert_array_equal(red.numpy(), host.sum(0))
    assert [e.primitive for e in tr.events] == [
        "scatter", "broadcast", "gather", "reduce"]
    assert [e.flow for e in tr.events] == ["im", "naive", "im", "im"]
    assert all(e.algorithm == "auto" and e.payload_bytes == host.nbytes
               and e.ici_bytes == host.nbytes and e.program_id is None
               for e in tr.events)
    # a torch host value keeps its device unless one is asked for
    t = c.scatter(torch.from_numpy(host), axis=0, device="cpu")
    assert t.device.type == "cpu" and torch.equal(t, dev)
