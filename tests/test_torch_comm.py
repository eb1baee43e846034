"""Conformance of the port's ported collectives: every Table II stage of
all_reduce, all_gather and reduce_scatter, bit-identical to the NumPy
oracles of ``repro.testing.oracles`` on integer-valued payloads (so every
reduction order is exact), on the conformance cubes of the JAX suite:
``ring8``, ``2x4`` with ``01`` and ``2x2x2`` with ``010``/``110``/``011``.
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
}
CELLS = [("ring8", "1"), ("2x4", "01"), ("2x2x2", "010"), ("2x2x2", "110"),
         ("2x2x2", "011")]
OPS = ["add", "max", "min"]
PAYLOAD = (8, 8)                 # both axes divisible by every group


def _setup(cube_name, bitmap, seed=0, dtype=np.float32):
    cube = Hypercube.build(CUBES[cube_name])
    x = integer_payload(cube, PAYLOAD, dtype=dtype, seed=seed)
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
    cube, c, x, _ = _setup("ring8", "1")
    t = torch.from_numpy(x)
    with pytest.raises(NotImplementedError, match="not ported"):
        c.all_to_all(t, split_axis=0, concat_axis=0)
    for name in ("scatter", "gather", "reduce", "broadcast"):
        with pytest.raises(NotImplementedError, match="not ported"):
            getattr(c, name)(t)
    for flow in ("ring", "tree", "hierarchical", "compressed"):
        with pytest.raises(NotImplementedError, match="not ported"):
            c.all_reduce(t, algorithm=flow)
    with pytest.raises(ValueError, match="unknown algorithm"):
        c.all_reduce(t, algorithm="bogus")
    # a pod-crossing additive all_reduce plans the hierarchical split,
    # which waits for its slice
    pod = Hypercube.build({"pod": 2, "dp": 2, "tp": 2}, pods=2)
    y = torch.from_numpy(integer_payload(pod, PAYLOAD))
    with pytest.raises(NotImplementedError, match="hierarchical"):
        pod.comm(("pod", "dp")).all_reduce(y)
    np.testing.assert_array_equal(
        pod.comm(("pod", "dp")).all_reduce(y, op="max").numpy(),
        oracles.all_reduce(y.numpy(), 3, [0, 1], "max"))
