"""The port's MoE slice held against the JAX package on the CPU.

Block level: ``_route``, ``moe_ffn_decode`` and ``moe_ffn`` on weights and
inputs made with NumPy (expert weights at unit scale, so the experts carry
the output), with batches whose repeated tokens overflow an expert's
capacity so that choices are dropped. Model level: ``forward_logits`` and
the launcher's decode loop for ``qwen2-moe-a2.7b`` and ``mixtral-8x7b`` at
smoke size on 1, 2, 4 and 8 PEs, with the JAX package's weights carried
across by ``from_jax_params``, and the top-k expert ids of every layer
recorded on both sides. Both packages compute in f32; every comparison
holds to 1e-4 * max(1, max|ref|), greedy tokens and expert ids exactly.

At 8 PEs the expert axis is ep=4 with etp=2, so the etp all-gather,
all-reduce and slice run. The stock smoke config's 4 heads do not split
over the 8-way attention tp of the sequence-parallel forward, in the JAX
package as in the port; the 8-PE forward uses the smoke config with 8
heads.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import repro.models.blocks as jax_blocks
import repro.models.lm as jax_lm
import repro.models.params as jax_params
import repro.models.serving as jax_serving
from repro.compat import shard_map
from repro.configs import get as jax_get
from repro.launch.mesh import make_mesh
from repro.models.topology import (
    build_serve_topology as jax_serve_topology,
    build_topology as jax_topology)
from repro.runtime.trainer import input_batch_specs

from repro_torch import configs
from repro_torch.launch import serve as launcher
from repro_torch.models import blocks
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    _moe_ffn_defs, from_jax_params, init_params, param_specs)
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
PES = [1, 2, 4, 8]
TOL = 1e-4          # f32 in both packages; relative to max(1, max|ref|)
CPU = torch.device("cpu")


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def _configs(arch, pes, heads=None):
    """Smoke configs of both packages with ep * etp = pes (ep <= the 4
    smoke experts)."""
    ep = min(pes, 4)
    kw = dict(ep=ep, etp=pes // ep)
    if heads:
        kw["n_heads"] = heads
    return (dataclasses.replace(jax_get(arch).scaled_for_smoke(), **kw),
            dataclasses.replace(configs.get(arch).scaled_for_smoke(), **kw))


def _mesh(pes):
    return make_mesh((1, pes), ("data", "model"))


def _bound(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


def _per_pe(t: torch.Tensor, cube_ndim: int) -> np.ndarray:
    return t.reshape((-1,) + tuple(t.shape[cube_ndim:])).numpy()


# --------------------------------------------------------------- recording
def _record_port_routes(monkeypatch, calls):
    """Every port ``_route`` call appends its top-k ids per PE."""
    route = blocks._route

    def recording(cfg, hn2d, router, cn):
        topi, topv, probs = route(cfg, hn2d, router, cn)
        calls.append(_per_pe(topi, cn))
        return topi, topv, probs

    monkeypatch.setattr(blocks, "_route", recording)


def _record_jax_routes(monkeypatch, calls, mesh_axes):
    """Every JAX ``_route`` call, run per shard, appends (PE index, top-k
    ids) from the device through a debug callback."""
    route = jax_blocks._route

    def cb(pe, topi):
        calls.append((int(pe), np.asarray(topi)))

    def recording(cfg, hn2d, router):
        topi, topv, probs = route(cfg, hn2d, router)
        jax.debug.callback(cb, lax.axis_index(mesh_axes), topi)
        return topi, topv, probs

    monkeypatch.setattr(jax_blocks, "_route", recording)


def _by_pe(jax_calls, n_pe):
    """JAX calls bucketed per PE, in each PE's call order."""
    out = [[] for _ in range(n_pe)]
    for pe, topi in jax_calls:
        out[pe].append(topi)
    return out


def _assert_same_routes(port_calls, jax_calls, n_pe):
    per_pe = _by_pe(jax_calls, n_pe)
    assert port_calls and all(len(p) == len(port_calls) for p in per_pe)
    for i, got in enumerate(port_calls):
        for pe in range(n_pe):
            np.testing.assert_array_equal(
                got[pe].reshape(per_pe[pe][i].shape), per_pe[pe][i],
                err_msg=f"call {i}, PE {pe}")


# ------------------------------------------------------------ block level
def _moe_weights(cfg, seed):
    """Global MoE leaves at unit scale (NumPy)."""
    rng = np.random.RandomState(seed)
    D, Fe, Ep = cfg.d_model, cfg.d_ff_expert, cfg.n_experts_padded
    w = {"fln": 0.1 * rng.standard_normal(D),
         "router": rng.standard_normal((D, Ep)) / math.sqrt(D) * 4,
         "we_g": rng.standard_normal((Ep, D, Fe)) / math.sqrt(D),
         "we_u": rng.standard_normal((Ep, D, Fe)) / math.sqrt(D),
         "we_d": rng.standard_normal((Ep, Fe, D)) / math.sqrt(Fe)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        w.update(ws_g=rng.standard_normal((D, Fs)) / math.sqrt(D),
                 ws_u=rng.standard_normal((D, Fs)) / math.sqrt(D),
                 ws_d=rng.standard_normal((Fs, D)) / math.sqrt(Fs))
    return {k: v.astype(np.float32) for k, v in w.items()}


def _repeated_tokens(rng, n, D, every=4):
    """(n, D) rows, all equal except every ``every``-th: the repeated row's
    experts overflow their capacity."""
    x = np.repeat(rng.standard_normal((1, D)), n, axis=0)
    x[::every] = rng.standard_normal((len(x[::every]), D))
    return x.astype(np.float32)


def _port_block_weights(pcfg, topo, w):
    defs = _moe_ffn_defs(pcfg, topo)
    specs = {k: d.spec for k, d in defs.items()}
    placed = {k: topo.cube.to_cube(torch.from_numpy(w[k]), specs[k])
              for k in defs}
    return blocks.gather_params(placed, specs, topo, torch.float32)


def _max_load(port_calls, C):
    """Most choices of one expert on one PE in the recorded calls."""
    return max(np.bincount(t[pe].reshape(-1)).max()
               for t in port_calls for pe in range(t.shape[0]))


def test_route_matches_jax_with_ties():
    """Equal router columns give equal probabilities: ``lax.top_k`` keeps
    the lowest expert index first, and so does the port."""
    _, pcfg = _configs("qwen2-moe-a2.7b", 1)
    pcfg = dataclasses.replace(pcfg, n_experts=6, ep=4, top_k=4)
    assert pcfg.n_experts_padded == 8
    rng = np.random.RandomState(0)
    D = pcfg.d_model
    router = rng.standard_normal((D, 8)).astype(np.float32)
    router[:, 5:] = router[:, 4:5]             # padded experts tie expert 4
    router[:, 1] = router[:, 0]
    hn = rng.standard_normal((16, D)).astype(np.float32)
    hn[:4] = 0.0                                # every expert ties
    ti, tv, tp = jax_blocks._route(pcfg, jnp.asarray(hn), jnp.asarray(router))
    pi, pv, pp = blocks._route(pcfg, torch.from_numpy(hn)[None],
                               torch.from_numpy(router)[None], 1)
    np.testing.assert_array_equal(pi[0].numpy(), np.asarray(ti))
    np.testing.assert_array_equal(pi[0, :4].numpy(),
                                  np.tile(np.arange(4), (4, 1)))
    np.testing.assert_allclose(pv[0].numpy(), np.asarray(tv), atol=1e-6)
    np.testing.assert_allclose(pp[0].numpy(), np.asarray(tp), atol=1e-6)


@pytest.mark.parametrize("pes", PES)
def test_moe_ffn_decode_matches_jax(f32_reference, monkeypatch, pes):
    jcfg, pcfg = _configs("qwen2-moe-a2.7b", pes)
    B = 8
    rng = np.random.RandomState(pes)
    w = _moe_weights(pcfg, 1)
    x = _repeated_tokens(rng, B, pcfg.d_model)
    jtopo = jax_serve_topology(jcfg, _mesh(pes))
    jspecs = {k: d.spec for k, d in jax_params._moe_ffn_defs(
        jcfg, jtopo).items()}

    def jfn(w_, x_):
        wg = jax_blocks.gather_params(w_, jspecs, jtopo)
        return jax_blocks.moe_ffn_decode(jcfg, jtopo, wg, x_)[0]

    ref = np.asarray(jax.jit(shard_map(
        jfn, mesh=jtopo.cube.mesh, in_specs=(jspecs, P()), out_specs=P(),
        check_vma=False))({k: jnp.asarray(v) for k, v in w.items()},
                          jnp.asarray(x)))

    topo = build_serve_topology(pcfg, pes)
    assert topo.cube.dim_sizes == tuple(jtopo.cube.mesh.devices.shape)
    calls = []
    _record_port_routes(monkeypatch, calls)
    out = blocks.moe_ffn_decode(pcfg, topo, _port_block_weights(pcfg, topo,
                                                                w),
                                topo.cube.to_cube(torch.from_numpy(x),
                                                  (None, None)))
    C = max(math.ceil(B * pcfg.top_k / pcfg.n_experts_padded
                      * pcfg.capacity_factor), 1)
    assert _max_load(calls, C) > C              # choices were dropped
    for got in _per_pe(out, topo.cube.ndim):
        assert np.abs(got - ref).max() <= _bound(ref)


@pytest.mark.parametrize("pes", PES)
def test_moe_ffn_matches_jax(f32_reference, monkeypatch, pes):
    """The sequence-parallel MoE block and its aux loss per PE."""
    jcfg, pcfg = _configs("qwen2-moe-a2.7b", pes)
    B, S = 2, 16
    rng = np.random.RandomState(10 + pes)
    w = _moe_weights(pcfg, 2)
    x = _repeated_tokens(rng, B * S, pcfg.d_model).reshape(B, S, -1)
    jtopo = jax_topology(jcfg, _mesh(pes))
    jspecs = {k: d.spec for k, d in jax_params._moe_ffn_defs(
        jcfg, jtopo).items()}
    xspec = P(jtopo.dp, jtopo.sp, None)

    def jfn(w_, x_):
        wg = jax_blocks.gather_params(w_, jspecs, jtopo)
        y, aux = jax_blocks.moe_ffn(jcfg, jtopo, wg, x_)
        return y, aux.reshape(1)

    ref, ref_aux = jax.jit(shard_map(
        jfn, mesh=jtopo.cube.mesh, in_specs=(jspecs, xspec),
        out_specs=(xspec, P(jtopo.sp)), check_vma=False))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    ref, ref_aux = np.asarray(ref), np.asarray(ref_aux)

    topo = build_topology(pcfg, pes)
    calls = []
    _record_port_routes(monkeypatch, calls)
    spec = (topo.dp, topo.sp, None)
    out, aux = blocks.moe_ffn(pcfg, topo, _port_block_weights(pcfg, topo, w),
                              topo.cube.to_cube(torch.from_numpy(x), spec))
    T = B * S // topo.size(topo.ep)
    C = math.ceil(T * pcfg.top_k / pcfg.n_experts_padded
                  * pcfg.capacity_factor)
    assert _max_load(calls, C) > C              # choices were dropped
    got = topo.cube.from_cube(out, spec).numpy()
    assert np.abs(got - ref).max() <= _bound(ref)
    np.testing.assert_allclose(aux.reshape(-1).numpy(), ref_aux, rtol=1e-5)


# ------------------------------------------------------------ model level
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_moe_weights(arch):
    jcfg, pcfg = _configs(arch, 8)
    jtopo = jax_serve_topology(jcfg, _mesh(8))
    jparams = jax.tree.map(np.asarray,
                           jax_params.init_params(jcfg, jtopo, seed=5))
    topo = build_serve_topology(pcfg, 8)
    params = from_jax_params(pcfg, topo, jparams, device=CPU)
    specs = param_specs(pcfg, topo)
    unit = params["units"]["p0"]
    assert {"router", "we_g", "we_u", "we_d"} <= set(unit)
    for k, leaf in unit.items():
        np.testing.assert_array_equal(
            topo.cube.from_cube(leaf, specs["units"]["p0"][k]).numpy(),
            jparams["units"]["p0"][k], err_msg=k)
    # expert e of PE (ep, etp): rows of the global leaf, columns etp-sharded
    we_g = jparams["units"]["p0"]["we_g"]
    E_loc = pcfg.n_experts_padded // topo.size(topo.ep)
    F_loc = pcfg.d_ff_expert // topo.size(topo.etp)
    np.testing.assert_array_equal(unit["we_g"][0, 1, 1].numpy(),
                                  we_g[:, E_loc:2 * E_loc, :, F_loc:])


def test_init_params_do_not_depend_on_the_cube():
    cfg = configs.get("qwen2-moe-a2.7b").scaled_for_smoke()
    trees = []
    for pes in (1, 8):
        topo = build_serve_topology(cfg, pes)
        params = init_params(cfg, topo, 3, device=CPU)
        specs = param_specs(cfg, topo)
        trees.append({k: topo.cube.from_cube(v, specs["units"]["p0"][k])
                      for k, v in params["units"]["p0"].items()})
    for k in trees[0]:
        torch.testing.assert_close(trees[0][k], trees[1][k], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pes", PES)
def test_forward_logits_matches_jax(f32_reference, monkeypatch, arch, pes):
    jcfg, pcfg = _configs(arch, pes, heads=8 if pes == 8 else None)
    B, S = 2, 16
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jtopo = jax_topology(jcfg, _mesh(pes))
    jparams = jax_params.init_params(jcfg, jtopo, seed=1)
    jcalls, pcalls = [], []
    _record_jax_routes(monkeypatch, jcalls, jtopo.cube.dim_names)
    fwd = jax.jit(shard_map(
        jax_lm.Model(jcfg, jtopo).forward_logits, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  input_batch_specs(jcfg, jtopo)),
        out_specs=P(jtopo.dp, None, jtopo.tp), check_vma=False))
    ref = np.asarray(fwd(jparams, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(tokens)}))
    jax.effects_barrier()

    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    _record_port_routes(monkeypatch, pcalls)
    cube = topo.cube
    logits = Model(pcfg, topo, dtype=torch.float32).forward_logits(
        params, {"tokens": cube.to_cube(torch.from_numpy(tokens).long(),
                                        (topo.dp, None))})
    got = cube.from_cube(logits, (topo.dp, None, topo.tp)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= _bound(ref)
    assert len(pcalls) == pcfg.n_layers
    _assert_same_routes(pcalls, jcalls, cube.ndev)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pes", PES)
def test_decode_matches_jax_on_launcher_loop(f32_reference, monkeypatch,
                                             arch, pes):
    """The launcher's loop -- teacher-forced prompt, then greedy -- through
    the JAX ``decode_shard`` and the port's, step by step (mixtral's
    window makes its cache a rolling one)."""
    jcfg, pcfg = _configs(arch, pes)
    B, prompt_len, gen = 2, 5, 4
    S_ctx = prompt_len + gen
    prompt = np.random.RandomState(4).randint(0, jcfg.vocab_size,
                                              (B, prompt_len))
    jtopo = jax_serve_topology(jcfg, _mesh(pes))
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S_ctx,
                                        global_batch=B)
    jparams = jax_params.init_params(jcfg, jtopo, seed=2)
    jcache = jax_serving.init_cache(jcfg, jtopo, jplan)
    cspecs = jax_serving.cache_specs(jcfg, jtopo, jplan)
    jba = jplan.batch_axes or None
    jcalls, pcalls = [], []
    _record_jax_routes(monkeypatch, jcalls, jtopo.cube.dim_names)
    jstep = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, jplan).decode_shard,
        mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo), cspecs, P(jba),
                  P(jba)),
        out_specs=(P(jba, jtopo.tp), cspecs), check_vma=False))

    topo = build_serve_topology(pcfg, pes)
    plan = make_serve_plan(pcfg, topo, S_ctx=S_ctx, global_batch=B)
    for f in dataclasses.fields(plan):
        assert getattr(plan, f.name) == getattr(jplan, f.name), f.name
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    cache = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
    _record_port_routes(monkeypatch, pcalls)
    cube = topo.cube
    ba = plan.batch_axes or None

    toks = prompt[:, 0]
    for t in range(S_ctx - 1):
        pos = np.full((B,), t, np.int32)
        ref, jcache = jstep(jparams, jcache, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(pos))
        ref = np.asarray(ref)
        logits, cache = server.decode_shard(
            params, cache, cube.to_cube(torch.from_numpy(toks).long(), (ba,)),
            cube.to_cube(torch.from_numpy(pos).long(), (ba,)))
        got = cube.from_cube(logits, (ba, topo.tp)).numpy()
        assert np.abs(got - ref).max() <= _bound(ref), t
        nxt = ref.argmax(-1)
        np.testing.assert_array_equal(got.argmax(-1), nxt)
        toks = prompt[:, t + 1] if t + 1 < prompt_len else nxt
    jax.effects_barrier()
    assert len(pcalls) == (S_ctx - 1) * pcfg.n_layers
    _assert_same_routes(pcalls, jcalls, cube.ndev)


def test_decode_all_to_all_plans_the_reorder_kernel():
    """At full width on 8 PEs (ep = 8) the decode dispatch buffer
    (64 experts x C=1 x 2048, bf16) plans the direct flow, which resolves to
    ``cm``: the stage that runs on the reorder kernel."""
    from repro_torch.core import planner
    cfg = configs.get("qwen2-moe-a2.7b")
    topo = build_serve_topology(cfg, 8)
    assert topo.cube.dim_sizes == (1, 8, 1)
    payload = cfg.n_experts_padded * 1 * cfg.d_model * 2
    est = planner.plan(topo.cube, "all_to_all", topo.ep, payload)
    assert (est.algorithm, est.stage) == ("direct", "cm")
    assert topo.comm(topo.ep)._resolve_flow(
        "all_to_all", "auto", payload)[0] == "cm"


def test_launcher_serves_moe_on_the_cpu():
    runs = [launcher.serve("qwen2-moe-a2.7b", batch=2, prompt_len=4, gen=3,
                           smoke=True, pes=p, device="cpu",
                           dtype=torch.float32) for p in (1, 4)]
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    assert str(runs[1]["topo"].cube.describe()).startswith(
        "Hypercube[data=1,ep=4,etp=1")
    # CPU: the plain versions, no kernel launch
    assert runs[1]["reorder_launches"] == 0 == runs[1]["flash_launches"]
