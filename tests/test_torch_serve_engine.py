"""The port's continuous-batching engine (``repro_torch.serving.engine``)
on the CPU, case for case with ``tests/test_serve_engine.py``, and held
against the JAX ``ServeEngine``.

A mixed-length Poisson trace completes with one recorded CommProgram per
step served from the lower cache; greedy outputs are batching-invariant;
preemption round-trips through the rooted-collective swap; temperature
sampling completes and repeats under one seed. Against the reference: the
same trace through both engines, f32 in both packages (the JAX compute
dtype is set with ``monkeypatch`` and restored), the JAX package's weights
carried across with ``from_jax_params``, must give identical greedy tokens
at tp 1 and 2.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.blocks as jax_blocks
import repro.models.lm as jax_lm
import repro.models.params as jax_params
import repro.models.serving as jax_serving
from repro.configs import get as jax_get
from repro.launch.mesh import make_mesh
from repro.models.topology import build_serve_topology as jax_serve_topology
from repro.serving import ServeEngine as JaxServeEngine

import jax
from repro_torch import configs
from repro_torch.core import program
from repro_torch.models.params import from_jax_params, init_params
from repro_torch.models.serving import make_serve_plan
from repro_torch.models.topology import build_serve_topology
from repro_torch.serving import Request, ServeEngine, poisson_trace
from repro_torch.telemetry import metrics as telemetry_metrics

ARCH = "qwen3-1.7b"
CPU = torch.device("cpu")


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


def _setup(B, *, tp=1, S_ctx=32, dtype=torch.float32, **eng_kw):
    cfg = configs.get(ARCH).scaled_for_smoke()
    if tp > 1:
        cfg = dataclasses.replace(cfg, tp=tp)
    topo = build_serve_topology(cfg, tp)
    plan = make_serve_plan(cfg, topo, S_ctx=S_ctx, global_batch=B)
    params = init_params(cfg, topo, 1, device=CPU)
    return cfg, ServeEngine(cfg, topo, plan, params, dtype=dtype,
                            device="cpu", **eng_kw)


def _trace(cfg, n, seed=3, temperature=0.0):
    return poisson_trace(n, rate=1.0, plen_range=(3, 8),
                         max_new_range=(3, 6), vocab=cfg.vocab_size,
                         seed=seed, temperature=temperature)


def _tokens(m) -> dict:
    return {r.rid: list(r.out_tokens) for r in m["finished"]}


def test_mixed_trace_completes_with_cached_programs():
    """One recorded CommProgram per step; every lowering after the first
    is a structural-fingerprint cache hit; the registry reads it."""
    cfg, eng = _setup(3)
    reqs = _trace(cfg, 6)
    m = eng.run(reqs)
    assert m["programs_recorded"] == m["steps"]
    assert program.LOWER_STATS["lowered"] == 1, \
        "per-step program must lower exactly once"
    assert program.LOWER_STATS["cache_hits"] == m["steps"] - 1
    assert len(m["finished"]) == 6
    for r in m["finished"]:
        assert len(r.out_tokens) == r.max_new, r.rid
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
    assert eng.metrics.value("serve.steps") == m["steps"]
    assert eng.metrics.value("serve.generated_tokens") == sum(
        r.max_new for r in reqs)
    assert eng.metrics.value("serve.lower_cache_hit_ratio") == \
        (m["steps"] - 1) / m["steps"]
    assert 0.0 <= eng.metrics.value("serve.page_occupancy") <= 1.0
    assert m["p50_token_s"] <= m["p99_token_s"]
    # the step program: 9 broadcasts of control state + 1 gather
    prims = [o.primitive for o in eng.last_program._ops]
    assert prims == ["broadcast"] * 9 + ["gather"]


def test_greedy_outputs_are_batching_invariant():
    """Each request decoded alone (B=1) gives the same greedy tokens as the
    continuously-batched run."""
    cfg, eng = _setup(3)
    batched = _tokens(eng.run(_trace(cfg, 5)))
    _, solo = _setup(1)
    for proto in _trace(cfg, 5):
        alone = dataclasses.replace(proto, arrival=solo.step_idx)
        ms = solo.run([alone])
        assert list(ms["finished"][-1].out_tokens) == batched[proto.rid], \
            proto.rid


def test_preemption_swap_preserves_outputs():
    """Tight page pools under lazy admission force preemption; the swap
    round-trip (rooted gather out / scatter back) changes no request's
    greedy continuation."""
    cfg, eng = _setup(3, tp=2)
    ref = _tokens(eng.run(_trace(cfg, 6)))
    _, tight = _setup(3, tp=2, pages_per_shard=4, admission="lazy")
    m = tight.run(_trace(cfg, 6))
    assert m["preemptions"] > 0, "pools sized to force preemption"
    assert tight.metrics.value("serve.preempted") == m["preemptions"]
    assert _tokens(m) == ref


def test_temperature_sampling_and_slot_reuse():
    """Temperature sampling completes with tokens in the vocab; more
    requests than lanes exercises slot reuse; one seed repeats its tokens
    and another seed draws other ones."""
    runs = []
    for seed in (0, 0, 5):
        cfg, eng = _setup(2, seed=seed)
        m = eng.run(_trace(cfg, 6, temperature=0.8))
        assert len(m["finished"]) == 6
        for r in m["finished"]:
            assert len(r.out_tokens) == r.max_new
            assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
        assert m["steps"] > max(r.admitted_step for r in m["finished"])
        runs.append(_tokens(m))
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    greedy = _tokens(_setup(2)[1].run(_trace(cfg, 6)))
    assert runs[0] != greedy


def test_engine_input_validation():
    cfg, eng = _setup(2, S_ctx=16)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=0, prompt=[], max_new=2))
    with pytest.raises(ValueError, match="S_ctx"):
        eng.submit(Request(rid=1, prompt=[1] * 10, max_new=10))
    with pytest.raises(ValueError, match="no tokens"):
        eng.submit(Request(rid=2, prompt=[1], max_new=0))
    with pytest.raises(ValueError, match="admission"):
        _setup(2, admission="eager")
    with pytest.raises(ValueError, match="could never run"):
        _setup(2, S_ctx=16, pages_per_shard=1)[1].submit(
            Request(rid=3, prompt=[1] * 8, max_new=4))


def test_engine_raises_for_unserved_plans():
    cfg, eng = _setup(2)
    plan = dataclasses.replace(eng.plan, batch_axes=("data",))
    with pytest.raises(NotImplementedError, match="batch_axes"):
        ServeEngine(cfg, eng.topo, plan, eng.params, device="cpu")
    encdec = dataclasses.replace(cfg, is_encoder_decoder=True)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServeEngine(encdec, eng.topo, eng.plan, eng.params, device="cpu")


def test_engine_runs_on_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    cfg, eng = _setup(2)
    with pytest.raises(RuntimeError, match="device"):
        ServeEngine(cfg, eng.topo, eng.plan, eng.params)


# ------------------------------------------------ against the JAX engine
@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


@pytest.mark.parametrize("tp", [1, 2])
def test_engine_greedy_tokens_match_jax_engine(f32_reference, tp):
    """The same Poisson trace through the JAX ServeEngine and the port's,
    f32 in both, weights carried across: identical greedy tokens and the
    same schedule (steps, admissions, finishes)."""
    B, S_ctx = 3, 32
    jcfg = dataclasses.replace(jax_get(ARCH).scaled_for_smoke(), tp=tp)
    jtopo = jax_serve_topology(jcfg, make_mesh((1, tp), ("data", "model")))
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S_ctx,
                                        global_batch=B)
    jparams = jax_params.init_params(jcfg, jtopo, seed=2)
    jeng = JaxServeEngine(jcfg, jtopo, jplan, jparams)
    ref = jeng.run(_trace(jcfg, 7, seed=4))

    cfg = dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), tp=tp)
    topo = build_serve_topology(cfg, tp)
    plan = make_serve_plan(cfg, topo, S_ctx=S_ctx, global_batch=B)
    params = from_jax_params(cfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    eng = ServeEngine(cfg, topo, plan, params, dtype=torch.float32,
                      device="cpu")
    got = eng.run(_trace(cfg, 7, seed=4))
    assert got["steps"] == ref["steps"]
    assert got["programs_recorded"] == ref["programs_recorded"]
    assert _tokens(got) == _tokens(ref)
    for a, b in zip(sorted(got["finished"], key=lambda r: r.rid),
                    sorted(ref["finished"], key=lambda r: r.rid)):
        assert (a.admitted_step, a.finished_step) == \
            (b.admitted_step, b.finished_step), a.rid
