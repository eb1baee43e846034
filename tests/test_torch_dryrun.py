"""The port's dry run (``repro_torch.launch.dryrun``) held against the
JAX package's on the CPU.

The port traces a cell on the ``meta`` device; the reference lowers and
compiles it for fake CPU devices. Held here, on the 8-device substrate
and the smoke configs: ``comm_drift``'s report equals the reference's on
the cases of ``tests/test_dryrun.py``; a pod-crossing all_reduce records
``all_reduce/hierarchical`` and runs reduce-scatter and all-gather bodies,
with no drift; each cell's per-PE ``argument_size_in_bytes`` equals the
reference's ``compiled.memory_analysis()`` exactly but for the leaves the
test names, token ids (the port holds them in int64, as its train step
and decode loop take them; the reference in int32); the ``CommTrace``
of prefill and decode at one unit of layers equals the reference's
lowering trace (one event per call site, a scanned unit traced once);
the two-point probe equals the full count at three units; the flops lie
in ``FLOPS_BAND`` of XLA's ``cost_analysis()``; ``long_500k`` is skipped
for archs that are not subquadratic.

The reference's train step does not lower on this jax (its
``check_vma=True`` shard_map raises on the cross-entropy scan carry,
``tests/test_torch_train.py``), so its argument bytes come from a jit over
the same three input structs with their shardings (``keep_unused``): an
XLA module's argument size is its entry parameters', whatever its body.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.blocks as jax_blocks
import repro.models.lm as jax_lm
import repro.models.params as jax_params
import repro.models.serving as jax_serving
from repro import configs as jax_configs
from repro.compat import shard_map
from repro.core.comm import CommTrace as JaxCommTrace
from repro.launch import dryrun as jax_dryrun
from repro.launch.mesh import make_mesh
from repro.models.params import param_specs as jax_param_specs
from repro.models.params import param_structs
from repro.models.serving import Server as JaxServer
from repro.models.serving import cache_specs, cache_structs
from repro.models.serving import make_serve_plan as jax_serve_plan
from repro.models.topology import (
    build_serve_topology as jax_serve_topology,
    build_topology as jax_topology)
from repro.runtime.trainer import TrainConfig as JaxTrainConfig
from repro.runtime.trainer import opt_structs

from repro_torch import configs
from repro_torch.core import program
from repro_torch.core.comm import BodyTrace, CommTrace
from repro_torch.core.hypercube import Hypercube
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_cube

PES = 8
B, S_TRAIN, S_CTX = 8, 32, 64
SHAPES = {"train": dict(kind="train", seq=S_TRAIN, batch=B),
          "prefill": dict(kind="prefill", seq=S_TRAIN, batch=B),
          "decode": dict(kind="decode", seq=S_CTX, batch=B)}
# port flops over XLA's: the port counts the matmul-class ops
# (FlopCounterMode), XLA every elementwise op and transcendental as well,
# so the port's count is the smaller; 0.68 - 0.85 read at one unit
FLOPS_BAND = (0.6, 1.0)
FLOW_KEYS = ("count", "stage", "payload_bytes", "ici_bytes", "dcn_bytes")


@pytest.fixture(autouse=True)
def _reset_port_state(monkeypatch):
    """The reference's own compute dtype, bf16 (another test module may
    set it to f32 when it is imported), and the port's lower caches reset
    after each test."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.bfloat16)
    yield
    program.clear_lower_cache()
    for k in program.LOWER_STATS:
        program.LOWER_STATS[k] = 0


# ---------------------------------------------------------- comm_drift
def _summary(by_flow, ici=1e6, dcn=0.0):
    return {"events": len(by_flow), "ici_bytes": ici, "dcn_bytes": dcn,
            "by_flow": {k: {"count": 1} for k in by_flow}}


DRIFT_CASES = {
    "clean": (_summary(["all_reduce/hierarchical", "all_gather/im"],
                       ici=1e6, dcn=1e5),
              {"reduce-scatter": {"count": 2, "result_bytes": 500_000},
               "all-gather": {"count": 4, "result_bytes": 900_000},
               "all-reduce": {"count": 1, "result_bytes": 200_000}}),
    "missing_schedule": (_summary(["all_reduce/hierarchical"], ici=1e6,
                                  dcn=1e5),
                         {"all-reduce": {"count": 1,
                                         "result_bytes": 1_100_000}}),
    "empty": (_summary(["all_reduce/im"]), {}),
    "underrun": (_summary(["all_reduce/im"], ici=1e6),
                 {"all-reduce": {"count": 1, "result_bytes": 1000}}),
    "rooted_only": (_summary(["scatter/im", "gather/im"]), {}),
}


@pytest.mark.parametrize("case", sorted(DRIFT_CASES))
def test_comm_drift_equals_the_reference_report(case):
    summary, collectives = DRIFT_CASES[case]
    got = dryrun.comm_drift(summary, collectives)
    want = jax_dryrun.comm_drift(summary, collectives)
    ratio, want_ratio = (got.pop("hlo_over_trace_bytes"),
                         want.pop("hlo_over_trace_bytes"))
    assert got == want
    assert ratio == pytest.approx(want_ratio, rel=1e-12) or ratio is None \
        is want_ratio


def test_pod_crossing_all_reduce_runs_the_hierarchical_hops():
    """The 2x2x2 pod cube (``pod`` over DCN): a pod-crossing all_reduce
    dispatches ``hierarchical``, whose reduce-scatter, DCN all-reduce and
    all-gather bodies run, and the report finds no drift."""
    cube = Hypercube.build({"pod": 2, "dp": 2, "tp": 2})
    comm = cube.comm(("pod", "dp"))
    x = torch.arange(2 * 2 * 2 * 4096, dtype=torch.float32).reshape(
        2, 2, 2, 4096)
    with CommTrace() as trace, BodyTrace() as bodies:
        y = comm.all_reduce(x)
    assert torch.equal(y, x.sum((0, 1), keepdim=True).expand_as(x))
    summary, ran = trace.summary(), bodies.summary()
    assert list(summary["by_flow"]) == ["all_reduce/hierarchical"]
    assert {k: (d["count"], d["by_group"]) for k, d in ran.items()} == {
        "reduce-scatter": (1, {"2": {"count": 1, "bytes": 2048 * 4}}),
        "all-reduce": (1, {"2": {"count": 1, "bytes": 2048 * 4}}),
        "all-gather": (1, {"2": {"count": 1, "bytes": 4096 * 4}})}
    rep = dryrun.comm_drift(summary, ran)
    assert rep["missing_ops"] == [] and not rep["drift"]


def test_body_trace_records_only_what_runs():
    """Nothing is recorded outside a trace, and a group of one moves
    nothing."""
    cube = Hypercube.build({"a": 1, "b": 4})
    x = torch.ones((1, 4, 8))
    with BodyTrace() as bodies:
        cube.comm(("a",)).all_reduce(x)
        cube.comm(("b",)).all_gather(x, axis=0)
    assert list(bodies.summary()) == ["all-gather"]
    cube.comm(("b",)).all_reduce(x)
    assert len(bodies.records) == 1


# ----------------------------------------------------------- the cells
def _configs(arch, units=None):
    jcfg = jax_configs.get(arch).scaled_for_smoke()
    pcfg = configs.get(arch).scaled_for_smoke()
    if units is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=jcfg.unit() * units)
        pcfg = dataclasses.replace(pcfg, n_layers=pcfg.unit() * units)
    return jcfg, pcfg


def _jax_lowered(jcfg, kind):
    """The reference's lowering of the cell on the 8-device substrate and
    its CommTrace (train: the stand-in over the step's input structs)."""
    mesh = make_mesh((PES,), ("x",))
    trace = JaxCommTrace()
    shape = SHAPES[kind]
    if kind == "train":
        topo = jax_topology(jcfg, mesh, global_batch=B)
        args = (param_structs(jcfg, topo),
                opt_structs(jcfg, topo, JaxTrainConfig()),
                jax_dryrun.input_structs(jcfg, topo, shape))
        return jax.jit(lambda p, o, b: jnp.zeros(()),
                       keep_unused=True).lower(*args), trace
    if kind == "prefill":
        topo = jax_topology(jcfg, mesh, global_batch=B)
        server = JaxServer(jcfg, topo, None)
        bst = jax_dryrun.input_structs(jcfg, topo, shape)
        bspecs = {k: P(topo.dp, *([None] * (len(v.shape) - 1)))
                  for k, v in bst.items()}
        fn = shard_map(server.prefill_shard, mesh=topo.cube.mesh,
                       in_specs=(jax_param_specs(jcfg, topo), bspecs),
                       out_specs=(P(topo.dp, topo.tp),
                                  jax_dryrun._prefill_cache_spec(
                                      server, jcfg, topo)),
                       check_vma=False)
        with trace:
            return jax.jit(fn).lower(param_structs(jcfg, topo), bst), trace
    topo = jax_serve_topology(jcfg, mesh)
    plan = jax_serve_plan(jcfg, topo, S_ctx=S_CTX, global_batch=B)
    server = JaxServer(jcfg, topo, plan)
    cspecs = cache_specs(jcfg, topo, plan)
    ba = plan.batch_axes or None
    tok = jax.ShapeDtypeStruct((B,), jnp.int32,
                               sharding=topo.cube.sharding(P(ba)))
    fn = shard_map(server.decode_shard, mesh=topo.cube.mesh,
                   in_specs=(jax_param_specs(jcfg, topo), cspecs, P(ba),
                             P(ba)),
                   out_specs=(P(ba, topo.tp), cspecs), check_vma=False)
    with trace:
        return jax.jit(fn, donate_argnums=(1,)).lower(
            param_structs(jcfg, topo), cache_structs(jcfg, topo, plan), tok,
            tok), trace


def _token_bytes(kind, pes_on_batch):
    """Per-PE bytes the port's int64 token ids hold beyond the reference's
    int32 ones: tokens and labels (B / data, S) in a train step, tokens in
    a prefill, the token and the position (B / batch shards,) in decode."""
    if kind == "decode":
        return 2 * 4 * B // pes_on_batch
    leaves = 2 if kind == "train" else 1
    return leaves * 4 * (B // pes_on_batch) * S_TRAIN


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_argument_bytes_equal_the_reference(arch, kind):
    jcfg, pcfg = _configs(arch)
    lowered, _ = _jax_lowered(jcfg, kind)
    want = lowered.compile().memory_analysis().argument_size_in_bytes
    rec = dryrun._cell(pcfg, SHAPES[kind], PES)
    # smoke configs at 8 PEs: train / prefill lay the batch over data 8;
    # decode replicates it over the model axes (batch axes: none)
    on_batch = PES if kind != "decode" else 1
    named = _token_bytes(kind, on_batch)
    assert rec["memory"]["argument_size_in_bytes"] == want + named
    assert rec["memory"]["output_size_in_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["compile_s"] is None and not rec["planner_drift"]["drift"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_one_unit_trace_and_flops_match_the_reference(arch, kind):
    jcfg, pcfg = _configs(arch, units=1)
    lowered, trace = _jax_lowered(jcfg, kind)
    want = trace.summary()["by_flow"]
    rec = dryrun._cell(pcfg, SHAPES[kind], PES)
    got = rec["comm_trace"]["by_flow"]
    assert sorted(got) == sorted(want)
    for flow in want:
        assert {k: got[flow][k] for k in FLOW_KEYS} == \
            {k: want[flow][k] for k in FLOW_KEYS}
    xla = lowered.compile().cost_analysis()["flops"]
    ratio = rec["cost"]["flops"] / xla
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_two_point_probe_equals_the_full_count(kind):
    """Nothing is scanned in the port, so the probe's extrapolation from
    one and two units is the count of three units traced whole. Decode on
    a multi-PE cube reads each layer's K and V cache slice where it lies
    (the cache is stacked over units behind the cube's axes, so one unit's
    slice is not contiguous, and the decode form takes it through a
    strided lead): no copy of it is made at any unit count, so every term
    is linear (``copy`` 0, and the probe equals the full count)."""
    pcfg = _configs("qwen3-1.7b", units=3)[1]
    probe = dryrun._probe(pcfg, lambda cfg: dryrun._cell(
        cfg, SHAPES[kind], PES))
    full = dryrun._cell(pcfg, SHAPES[kind], PES)
    assert probe["n_units"] == 3
    copy = 0                # no copy of the cache slice in any kind
    assert probe["cost_x"]["flops"] == full["cost"]["flops"]
    assert probe["cost_x"]["bytes accessed"] == \
        full["cost"]["bytes accessed"] + copy
    for op, d in full["collectives"].items():
        assert probe["collectives_x"][op]["count"] == d["count"]
        assert probe["collectives_x"][op]["result_bytes"] == \
            d["result_bytes"]


def test_lowp_is_set_for_the_trace_and_reset():
    from repro_torch.models import layers
    seen = []
    real = dryrun._cell

    def cell(*args, **kw):
        seen.append(layers.LOWP)
        return {"cost": {}, "collectives": {}, "comm_seconds": None}

    dryrun._cell = cell
    try:
        dryrun._lower_cell_cfg(None, "train_4k", multi_pod=False, lowp=2)
    finally:
        dryrun._cell = real
    assert seen == [2] and layers.LOWP == 0


@pytest.mark.parametrize("arch", sorted(configs.ALIASES))
def test_long_500k_is_skipped_for_full_attention(arch):
    """Skipped exactly where the reference skips it: every arch that is not
    subquadratic (gemma3, mixtral, rwkv6 and jamba run it)."""
    cfg = configs.get(arch)
    assert cfg.subquadratic == jax_configs.get(arch).subquadratic
    if cfg.subquadratic:
        return
    rec = dryrun.run_cell(arch, "long_500k", multi_pod=False)
    assert rec["status"] == "skipped" and "memory" not in rec


def test_production_decode_cell():
    """qwen3-1.7b's decode_32k on the 256-PE production cube: the
    record's keys, a 256-way tp cube, per-PE bytes of the cube's share."""
    assert production_cube() == (256, 1)
    assert production_cube(True) == (512, 2)
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", multi_pod=False)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["cube"].startswith("Hypercube[data=1,tp=256")
    for key in ("comm_trace", "est_sources", "program_cache", "telemetry",
                "lower_s", "memory", "cost", "collectives",
                "planner_drift", "serve_plan"):
        assert key in rec
    assert not rec["planner_drift"]["drift"]
    assert rec["memory"]["argument_size_in_bytes"] > 0
