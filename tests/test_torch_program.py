"""The port's deferred CommProgram (``repro_torch.core.program``) on the
CPU, case for case with ``tests/test_program.py`` where the port has the
surface:

* recording defers dispatch (no events, symbolic values, op accounting);
* one-op programs are bit-identical to eager dispatch for every ported
  primitive and stage (and to the NumPy oracles, on integer payloads);
* rs+ag fusion equals the eager all_reduce, with provenance;
* the all_reduce -> rs+ag split rewrite; same-group coalescing equals
  per-leaf all-reduces; the multi-dim all_to_all chain merge;
* ``plan_program``'s ``order`` / ``levels`` equal the JAX package's on the
  same op lists, on single-domain cubes;
* the structural-fingerprint lower cache hits on equal structure;
* execute_async futures in dependency order.
"""
import numpy as np
import pytest
import torch

from repro.core import planner as jax_planner
from repro.testing import oracles
from repro.testing.substrate import integer_payload

from repro_torch.core import planner, program
from repro_torch.core.comm import CommTrace
from repro_torch.core.hypercube import Hypercube
from repro_torch.core.program import CommProgram, ProgramValue
from repro_torch.telemetry import metrics as telemetry_metrics

CUBES = {"ring8": {"d": 8}, "2x4": {"r": 2, "c": 4},
         "2x2x2": {"a": 2, "b": 2, "c": 2}}


@pytest.fixture(autouse=True)
def _reset_port_observability():
    """The port's counterpart of conftest's reset: LOWER_STATS, every
    cube's lower cache and the telemetry registry, around each test."""
    program.clear_lower_cache()
    for k in program.LOWER_STATS:
        program.LOWER_STATS[k] = 0
    yield
    program.clear_lower_cache()
    for k in program.LOWER_STATS:
        program.LOWER_STATS[k] = 0
    telemetry_metrics.disable()
    telemetry_metrics.REGISTRY.reset()


def _cube(name):
    return Hypercube.build(CUBES[name])


def _aval(cube, payload, dtype=torch.float32):
    return (cube.dim_sizes + tuple(payload), dtype)


def _x(cube, payload, seed):
    return torch.from_numpy(integer_payload(cube, payload, seed=seed))


# ------------------------------------------------------------- recording
def test_recording_defers_dispatch():
    cube = _cube("ring8")
    comm = cube.comm("1")
    with CommTrace() as tr:
        with comm.program(name="rec") as prog:
            a = prog.input(_aval(cube, (2, 16)))
            b = comm.reduce_scatter(a, axis=1)
            c = comm.all_gather(b, axis=1)
            prog.output(c)
    assert tr.events == []                       # nothing dispatched
    assert isinstance(b, ProgramValue) and isinstance(c, ProgramValue)
    assert b.shape == (8, 2, 2) and c.shape == (8, 2, 16)
    assert b.dim() == 3 and c.size == 8 * 32
    assert len(prog._ops) == 2
    assert "reduce_scatter" in prog.describe()
    assert prog.program_id == "rec"


def test_program_validation():
    ring, other = _cube("ring8"), _cube("ring8")   # equal, not the same
    comm = ring.comm("1")
    prog = ring.program()
    with prog:
        a = prog.input(_aval(ring, (8,)))
        with pytest.raises(ValueError, match="different cube"):
            other.comm("1").all_reduce(a)
        with pytest.raises(RuntimeError, match="still recording"):
            prog.lower()
        comm.all_reduce(a)
    with pytest.raises(ValueError, match="takes 1 inputs"):
        prog.execute()
    with pytest.raises(RuntimeError, match="already recorded"):
        with prog:
            pass
    with pytest.raises(ValueError, match="not divisible"):
        with ring.program() as p2:
            comm.reduce_scatter(p2.input(_aval(ring, (3,))), axis=0)


def test_scopes_from_cube_comm_and_topology_share_the_cube():
    from repro_torch import configs
    from repro_torch.models.topology import build_serve_topology
    cfg = configs.get("qwen3-1.7b").scaled_for_smoke()
    topo = build_serve_topology(cfg, 1)
    for scope in (topo.program(name="t"), topo.cube.program(name="c"),
                  topo.comm(topo.tp).program(name="m")):
        assert isinstance(scope, CommProgram) and scope.cube is topo.cube


# ------------------------------------------------- one-op program parity
def _one_op_cases():
    stages = {
        "all_reduce": ["naive", "pr", "im", "auto", "pidcomm"],
        "reduce_scatter": ["naive", "pr", "im", "auto"],
        "all_gather": ["naive", "pr", "im", "cm", "auto"],
        "all_to_all": ["naive", "pr", "im", "cm", "auto"],
        "scatter": ["naive", "im", "auto"],
        "gather": ["naive", "im", "auto"],
        "reduce": ["naive", "pr", "im", "auto"],
        "broadcast": ["naive", "auto"],
    }
    return [(c, b, p, s) for c, b in (("ring8", "1"), ("2x4", "01"),
                                      ("2x2x2", "011"))
            for p, ss in stages.items() for s in ss]


@pytest.mark.parametrize("cube_name,bitmap,primitive,alg", _one_op_cases())
def test_one_op_program_bit_identical_to_eager(cube_name, bitmap,
                                               primitive, alg):
    """Eager single-op calls remain supported as one-op programs: the
    program path executes the identical registry body, bit-identically,
    and both equal the NumPy oracle."""
    cube = _cube(cube_name)
    names = cube.dims_from_bitmap(bitmap)
    idx = tuple(cube.dim_names.index(d) for d in names)
    comm = cube.comm(names)
    nd, g = cube.ndim, cube.group_size(names)
    x = integer_payload(cube, (2, 4 * g), seed=g)
    host = np.random.RandomState(g).randint(-4, 5, (4 * g, 3)) \
        .astype(np.float32)
    dev = torch.from_numpy(oracles.scatter(host, cube.dim_sizes, idx,
                                           axis=0))
    call, arg, oracle = {
        "all_to_all": (lambda v: comm.all_to_all(
            v, split_axis=1, concat_axis=1, algorithm=alg),
            torch.from_numpy(x), lambda: oracles.all_to_all(
                x, nd, idx, split_axis=1, concat_axis=1)),
        "reduce_scatter": (lambda v: comm.reduce_scatter(
            v, axis=1, algorithm=alg), torch.from_numpy(x),
            lambda: oracles.reduce_scatter(x, nd, idx, axis=1)),
        "all_gather": (lambda v: comm.all_gather(v, axis=0, algorithm=alg),
                       torch.from_numpy(x),
                       lambda: oracles.all_gather(x, nd, idx, axis=0)),
        "all_reduce": (lambda v: comm.all_reduce(v, algorithm=alg),
                       torch.from_numpy(x),
                       lambda: oracles.all_reduce(x, nd, idx)),
        "scatter": (lambda v: comm.scatter(v, axis=0, algorithm=alg),
                    torch.from_numpy(host),
                    lambda: oracles.scatter(host, cube.dim_sizes, idx,
                                            axis=0)),
        "gather": (lambda v: comm.gather(v, axis=0, algorithm=alg), dev,
                   lambda: host),
        "reduce": (lambda v: comm.reduce(v, op="max", axis=0,
                                         algorithm=alg), dev,
                   lambda: oracles.reduce(host, axis=0, op="max")),
        "broadcast": (lambda v: comm.broadcast(v, algorithm=alg),
                      torch.from_numpy(host),
                      lambda: oracles.broadcast(host, cube.dim_sizes)),
    }[primitive]
    eager = call(arg)
    with cube.program() as prog:
        prog.output(call(prog.input(arg)))
    with CommTrace() as tr:
        via_prog = prog.execute(arg)
    assert via_prog.shape == prog._avals[prog._output_vids[0]].shape
    assert torch.equal(via_prog, eager)              # bit-identical
    np.testing.assert_array_equal(via_prog.numpy(), oracle())
    [ev] = tr.events
    assert ev.program_id == prog.program_id and ev.fused_from == ()


# ----------------------------------------------------------- rs+ag fusion
def _record_rs_ag(cube, comm, payload):
    prog = cube.program(name="rsag")
    with prog:
        a = prog.input(_aval(cube, payload))
        b = comm.reduce_scatter(a, axis=1)
        prog.output(comm.all_gather(b, axis=1))
    return prog


def test_fused_rs_ag_equals_eager_all_reduce():
    """A recorded rs+ag pair executes as one all_reduce, with fused_from
    provenance on the CommTrace event, bit-identical to the eager
    all_reduce; the event count drops 2 -> 1 at equal bytes (the flat
    byte model ties the pair with the fused collective)."""
    cube = _cube("2x2x2")
    comm = cube.comm("110")
    g = comm.group_size
    x = _x(cube, (2, 4 * g), 7)
    prog = _record_rs_ag(cube, comm, (2, 4 * g))
    low = prog.lower()
    [fused] = low.ops
    assert fused.primitive == "all_reduce"
    assert fused.fused_from == (0, 1) and not fused.coalesced
    with CommTrace() as tr:
        got = low.execute(x)
    with CommTrace() as eager_tr:
        pair = comm.all_gather(comm.reduce_scatter(x, axis=1), axis=1)
    assert torch.equal(got, comm.all_reduce(x))
    assert torch.equal(got, pair)
    np.testing.assert_array_equal(got.numpy(),
                                  oracles.all_reduce(x.numpy(), 3, (0, 1)))
    [ev] = tr.events
    assert ev.primitive == "all_reduce" and ev.flow == "im"
    assert ev.program_id == "rsag" and ev.fused_from == (0, 1)
    assert len(eager_tr.events) == 2
    assert tr.total_bytes() == eager_tr.total_bytes()
    s = tr.summary()
    assert s["fused_events"] == 1 and s["fused_from_ops"] == 2
    assert s["programs"] == ["rsag"] and s["est_sources"] == {"analytic": 1}


def test_no_fusion_when_shard_is_consumed():
    cube = _cube("ring8")
    comm = cube.comm("1")
    prog = cube.program()
    with prog:
        a = prog.input(_aval(cube, (2, 16)))
        b = comm.reduce_scatter(a, axis=1)
        c = comm.all_gather(b, axis=1)
        prog.output(b, c)                      # the shard itself is needed
    low = prog.lower()
    assert [o.primitive for o in low.ops] == ["reduce_scatter", "all_gather"]
    x = _x(cube, (2, 16), 2)
    shard, full = low.execute(x)
    np.testing.assert_array_equal(
        shard.numpy(), oracles.reduce_scatter(x.numpy(), 1, (0,), axis=1))
    np.testing.assert_array_equal(full.numpy(),
                                  oracles.all_reduce(x.numpy(), 1, (0,)))


def test_split_all_reduce_rewrite():
    """Under forced mode an all_reduce becomes the rs+ag pair (provenance
    on both halves), bit-identical; the default "cost" mode keeps the fused
    collective (the split ties it on the byte model)."""
    cube = _cube("ring8")
    comm = cube.comm("1")
    prog = cube.program()
    with prog:
        a = prog.input(_aval(cube, (16, 3)))
        prog.output(comm.all_reduce(a))
    low = prog.lower(split_all_reduce=True)
    assert [o.primitive for o in low.ops] == ["reduce_scatter", "all_gather"]
    assert all(o.fused_from == (0,) for o in low.ops)
    x = _x(cube, (16, 3), 9)
    np.testing.assert_array_equal(low.execute(x).numpy(),
                                  oracles.all_reduce(x.numpy(), 1, (0,)))
    assert [o.primitive for o in prog.lower().ops] == ["all_reduce"]


# ------------------------------------------------------------- coalescing
def test_coalesced_all_reduces_equal_per_leaf_all_reduces():
    """Independent small all-reduces on one group dispatch as one bucketed
    all_reduce, bit-identical to the per-leaf eager all-reduces."""
    cube = _cube("2x2x2")
    comm = cube.comm("111")
    shapes = [(6,), (2, 5), (3,)]
    xs = [_x(cube, s, i + 1) for i, s in enumerate(shapes)]
    prog = cube.program(name="bucket")
    with prog:
        prog.output(*[comm.all_reduce(prog.input(_aval(cube, s)))
                      for s in shapes])
    low = prog.lower()
    [op] = low.ops
    assert op.coalesced and op.fused_from == (0, 1, 2)
    with CommTrace() as coal_tr:
        got = low.execute(*xs)
    with CommTrace() as eager_tr:
        want = [comm.all_reduce(x) for x in xs]
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    np.testing.assert_array_equal(got[0].numpy(), oracles.all_reduce(
        xs[0].numpy(), 3, (0, 1, 2)))
    assert len(eager_tr.events) == 3 and len(coal_tr.events) == 1
    [ev] = coal_tr.events
    assert len(ev.fused_from) == 3
    assert ev.payload_bytes == sum(e.payload_bytes for e in eager_tr.events)
    # a staged bucket is consumed instead of re-concatenated
    ex = low.execute_async(*xs).stage()
    assert list(ex._staged) == [op.op_id]
    for g_, w in zip(ex.outputs(), want):
        assert torch.equal(g_, w)
    assert not ex._staged


def test_multiple_coalesce_buckets_all_survive():
    cube = _cube("2x2x2")
    groups = [("a",), ("a", "c"), ("a", "b", "c")]
    prog = cube.program()
    vals = []
    with prog:
        for gi, dims in enumerate(groups):
            comm = cube.comm(dims)
            for k in range(2):
                v = prog.input(_aval(cube, (4 + gi + k,)))
                vals.append(comm.all_reduce(v))
        prog.output(*vals)
    low = prog.lower()
    assert len(low.ops) == 3 and all(o.coalesced for o in low.ops)
    assert sorted(o.comm.dims for o in low.ops) == sorted(groups)
    xs = [_x(cube, (4 + gi + k,), 10 * gi + k)
          for gi in range(3) for k in range(2)]
    got = low.execute(*xs)
    for i, (x, r) in enumerate(zip(xs, got)):
        idx = tuple(cube.dim_names.index(d) for d in groups[i // 2])
        np.testing.assert_array_equal(r.numpy(),
                                      oracles.all_reduce(x.numpy(), 3, idx))


def test_coalescing_respects_size_and_group():
    cube = _cube("2x2x2")
    big = 1 << 19                                    # 2 MiB of f32 > 1 MiB
    c_all, c_c = cube.comm(("a", "b")), cube.comm(("c",))
    prog = cube.program()
    with prog:
        i1 = prog.input(_aval(cube, (8,)))
        i2 = prog.input(_aval(cube, (12,)))
        i3 = prog.input(_aval(cube, (big,)))
        i4 = prog.input(_aval(cube, (8,)))
        prog.output(c_all.all_reduce(i1), c_all.all_reduce(i2),
                    c_all.all_reduce(i3), c_c.all_reduce(i4))
    low = prog.lower()
    coalesced = [o for o in low.ops if o.coalesced]
    assert len(coalesced) == 1 and len(coalesced[0].fused_from) == 2
    assert len(low.ops) == 3                         # bucket + big + c


def test_provenance_chains_to_recorded_ops():
    """fused_from always names *recorded* op ids, through a fusion that
    coalescing then absorbs; future_for resolves a recorded op through
    that provenance."""
    cube = _cube("2x2x2")
    comm = cube.comm(("a", "b"))
    prog = cube.program()
    with prog:
        a = prog.input(_aval(cube, (2, 8)))
        fused = comm.all_gather(comm.reduce_scatter(a, axis=1), axis=1)
        b = prog.input(_aval(cube, (2, 8)))
        plain = comm.all_reduce(b)
        prog.output(fused, plain)
    low = prog.lower()
    [op] = low.ops
    assert op.coalesced
    assert sorted(op.fused_from) == [0, 1, 2]        # rs, ag, plain ar
    xa, xb = _x(cube, (2, 8), 1), _x(cube, (2, 8), 2)
    ex = low.execute_async(xa, xb)
    assert torch.equal(ex.future_for(plain).result(), comm.all_reduce(xb))
    assert torch.equal(ex.future_for(1).result(), comm.all_reduce(xa))
    with pytest.raises(KeyError):
        ex.future_for(7)


# ---------------------------------------------------------- joint planning
def _spec_lists(names):
    """Op lists over the dims of a cube: every primitive, explicit stages,
    dependencies, and payloads that tie."""
    d0, d1 = names[0], names[-1]
    P = planner.ProgramOpSpec
    mb = float(1 << 20)
    return [
        [P(0, "all_reduce", (d0,), mb), P(1, "all_gather", (d1,), 2 * mb),
         P(2, "reduce_scatter", (d0,), mb, deps=(1,)),
         P(3, "all_to_all", names, mb / 2)],
        [P(0, "broadcast", names, 64.0), P(1, "broadcast", names, 4096.0),
         P(2, "gather", names, 32.0), P(3, "scatter", (d1,), 1024.0),
         P(4, "reduce", (d0,), 512.0, deps=(2,), op="max")],
        [P(0, "all_reduce", names, mb, algorithm="naive"),
         P(1, "all_reduce", names, mb, algorithm="im"),
         P(2, "all_reduce", names, mb, algorithm="pr", deps=(0, 1)),
         P(3, "all_gather", (d0,), mb, algorithm="cm", deps=(2,)),
         P(4, "all_to_all", (d1,), mb, deps=(2,))],
        [P(i, "all_reduce", (d0,), 256.0) for i in range(5)],
    ]


@pytest.mark.parametrize("cube_name", ["ring8", "2x2x2"])
@pytest.mark.parametrize("case", range(4))
def test_plan_program_order_matches_jax(cube_name, case, request):
    """Single-domain cubes: the same op lists give the reference's levels
    and interleaving order (it ranks by seconds, the port by bytes: one
    ranking on one link), and the same per-op bytes."""
    jcube = request.getfixturevalue(f"cube_{cube_name}")
    cube = _cube(cube_name)
    ops = _spec_lists(cube.dim_names)[case]
    jops = [jax_planner.ProgramOpSpec(
        o.op_id, o.primitive, o.dims, o.payload_bytes, deps=o.deps,
        algorithm=o.algorithm, op=o.op) for o in ops]
    got = planner.plan_program(cube, ops)
    want = jax_planner.plan_program(jcube, jops)
    assert got.order == want.order
    assert got.levels == want.levels
    for i, e in got.estimates.items():
        w = want.estimates[i]
        assert (e.ici_bytes, e.dcn_bytes) == (w.ici_bytes, w.dcn_bytes), i
    assert got.seconds is None and got.serial_seconds is None
    assert got.est_source == "analytic"


def test_plan_program_levels_and_cycles():
    cube = Hypercube.build({"pod": 2, "dp": 2, "tp": 2}, pods=2)
    P = planner.ProgramOpSpec
    mb = float(1 << 20)
    plan = planner.plan_program(cube, [
        P(0, "all_reduce", ("pod", "dp"), mb, algorithm="im"),
        P(1, "all_gather", ("tp",), mb),
        P(2, "all_reduce", ("pod", "dp"), mb, algorithm="im", op="max"),
        P(3, "reduce_scatter", ("tp",), mb, deps=(1,)),
    ])
    assert plan.order.index(1) < plan.order.index(3)
    assert plan.levels[1] == (3,)
    # a DCN-dominant op leads the wave, an ICI one follows
    doms = [plan.estimates[i].dominant() for i in plan.levels[0][:2]]
    assert doms == ["dcn", "ici"]
    assert plan.estimates[0].algorithm == "hierarchical"
    assert plan.estimates[2].algorithm == "direct"   # max cannot split
    with pytest.raises(ValueError, match="cyclic"):
        planner.plan_program(cube, [P(0, "all_reduce", ("tp",), mb,
                                      deps=(1,)),
                                    P(1, "all_reduce", ("tp",), mb,
                                      deps=(0,))])


# ------------------------------------------------------------ lower cache
def _broadcast_program(cube, host, dev_tokens, name=""):
    comm = cube.comm(cube.dim_names)
    prog = cube.program(name=name)
    with prog:
        prev = prog.input(dev_tokens)
        prog.output(comm.broadcast(host), comm.gather(prev, spec=(None,)))
    return prog


def test_lower_cache_hits_on_equal_structure():
    """Programs of equal structure share one lowering, each executing with
    its own constants; another structure, knob or profile misses."""
    cube = _cube("2x2x2")
    toks = torch.arange(8 * 3).reshape(2, 2, 2, 3)
    outs = []
    for step in range(3):
        host = np.full((4,), step, np.int32)
        prog = _broadcast_program(cube, host, toks, name="step")
        outs.append(prog.execute(toks))
    assert program.LOWER_STATS == {"lowered": 1, "cache_hits": 2}
    for step, (rep, got) in enumerate(outs):
        assert rep.shape == (2, 2, 2, 4) and bool((rep == step).all())
        assert torch.equal(got, toks[0, 0, 0])
    _broadcast_program(cube, np.zeros(5, np.int32), toks).lower()
    assert program.LOWER_STATS["lowered"] == 2        # another shape
    _broadcast_program(cube, np.zeros(4, np.int32), toks).lower(
        coalesce=False)
    assert program.LOWER_STATS["lowered"] == 3        # another knob

    class Profile:
        def token(self):
            return "measured-on-the-card"

    with planner.install_profile(Profile()):
        _broadcast_program(cube, np.zeros(4, np.int32), toks).lower()
        _broadcast_program(cube, np.zeros(4, np.int32), toks).lower()
    assert program.LOWER_STATS == {"lowered": 4, "cache_hits": 3}
    with planner.install_profile(object()):          # no token: no caching
        _broadcast_program(cube, np.zeros(4, np.int32), toks).lower()
        _broadcast_program(cube, np.zeros(4, np.int32), toks).lower()
    assert program.LOWER_STATS == {"lowered": 6, "cache_hits": 3}
    # an equal cube is another cache
    _broadcast_program(_cube("2x2x2"), np.zeros(4, np.int32), toks).lower()
    assert program.LOWER_STATS["lowered"] == 7
    program.clear_lower_cache()
    _broadcast_program(cube, np.zeros(4, np.int32), toks).lower()
    assert program.LOWER_STATS["lowered"] == 8


def test_lower_cache_counts_in_telemetry():
    cube = _cube("ring8")
    toks = torch.zeros(8, 3, dtype=torch.int64)
    with telemetry_metrics.scoped_metrics() as reg:
        for _ in range(3):
            _broadcast_program(cube, np.ones(2, np.int32), toks).execute(toks)
    assert reg.value("program.lowered") == 1
    assert reg.value("program.lower_cache_hits") == 2
    assert reg.value("comm.dispatches") == 6
    assert reg.value("comm.est_source.analytic") == 6


# ------------------------------------------------------------------ async
def test_execute_async_futures():
    cube = _cube("ring8")
    comm = cube.comm("1")
    prog = cube.program()
    with prog:
        a = prog.input(_aval(cube, (2, 16)))
        prog.output(comm.all_gather(comm.reduce_scatter(a, axis=1), axis=1))
    low = prog.lower(fuse=False)                     # keep both ops live
    assert len(low.ops) == 2
    x = _x(cube, (2, 16), 8)
    ex = low.execute_async(x)
    assert not any(f.done() for f in ex.futures)
    out = ex.futures[1].result()                     # forces the rs dep too
    assert all(f.done() for f in ex.futures)
    np.testing.assert_array_equal(out.numpy(),
                                  oracles.all_reduce(x.numpy(), 1, (0,)))


# -------------------------------------------------- all_to_all chain merge
def test_merge_a2a_chain_bit_identical():
    """Consecutive all_to_all ops over disjoint dims lower to ONE chained
    op planned over the union of the dims; execution stays the sequential
    chain, bit-identical to the unfused program and the composed oracles."""
    cube = _cube("2x2x2")
    ca, cc = cube.comm("100"), cube.comm("001")
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 2, 2, 16)
                         .astype(np.float32))
    prog = cube.program(name="aa-chain")
    with prog:
        v = prog.input(_aval(cube, (16,)))
        w = ca.all_to_all(v, split_axis=0, concat_axis=0)
        prog.output(cc.all_to_all(w, split_axis=0, concat_axis=0))
    merged, plain = prog.lower(), prog.lower(merge_a2a=False)
    assert len(plain.ops) == 2 and len(merged.ops) == 1
    mop = merged.ops[0]
    assert mop.fused_from == (0, 1) and len(mop.chain) == 2
    assert mop.comm.dims == ("a", "c")
    assert merged.plan.estimates[mop.op_id].primitive == "all_to_all"
    with CommTrace() as tr:
        got = merged.execute(x)
    assert torch.equal(got, plain.execute(x))
    o = oracles.all_to_all(x.numpy(), 3, (0,), split_axis=0, concat_axis=0)
    o = oracles.all_to_all(o, 3, (2,), split_axis=0, concat_axis=0)
    np.testing.assert_array_equal(got.numpy(), o)
    assert [e.primitive for e in tr.events] == ["all_to_all", "all_to_all"]
    assert all(e.fused_from == (0, 1) and e.program_id == "aa-chain"
               for e in tr.events)


def test_merge_a2a_requires_disjoint_dims():
    cube = _cube("2x2x2")
    cab, cbc = cube.comm("110"), cube.comm("011")
    prog = cube.program()
    with prog:
        v = prog.input(_aval(cube, (16,)))
        w = cab.all_to_all(v, split_axis=0, concat_axis=0)
        prog.output(cbc.all_to_all(w, split_axis=0, concat_axis=0))
    assert len(prog.lower().ops) == 2                # shared dim "b"
    ca, cc = cube.comm("100"), cube.comm("001")
    prog2 = cube.program()
    with prog2:
        v = prog2.input(_aval(cube, (16,)))
        w = ca.all_to_all(v, split_axis=0, concat_axis=0)
        out = cc.all_to_all(w, split_axis=0, concat_axis=0)
        prog2.output(w, out)                         # intermediate escapes
    assert len(prog2.lower().ops) == 2
