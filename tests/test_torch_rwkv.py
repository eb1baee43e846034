"""The port's RWKV6 slice held against the JAX package on the CPU.

Block level: ``rwkv_mix`` and ``rwkv_channel_mix`` (with their prefill
cache outputs) and their decode forms, on weights and inputs made with
NumPy at unit scale, so that each block's own output carries the result.
Model level: ``forward_logits``, the launcher's decode loop, and
``prefill_shard`` (last-position logits and the state, shift and cm_shift
cache) for ``rwkv6-7b`` at smoke size, with the JAX package's weights
carried across by ``from_jax_params``. Each in f32 in both packages, held
to 1e-4 * max(1, max|ref|) with greedy tokens exactly, and each again in
bf16 in both packages (JAX's own compute dtype), held to a bf16 ulp or
two (``_close_bf16``).

On 1, 2 and 4 PEs the stock smoke config (4 heads of 16); on 8 PEs the
smoke config with d_model 128 (8 heads of 16): the stock config's 4 heads
leave 0 heads per PE under 8-way tp, in the JAX package as in the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
from repro_torch.kernels.rwkv6 import rwkv6
from repro_torch.launch import serve as launcher
from repro_torch.models import blocks
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    _rwkv_defs, _rwkvcm_defs, from_jax_params, init_params, param_specs)
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology

ARCH = "rwkv6-7b"
PES = [1, 2, 4, 8]
TOL = 1e-4          # f32 in both packages; relative to max(1, max|ref|)
BF16_TOL = 2.0 ** -6    # bf16 in both packages: two bf16 ulps at the max
BF16_F32_TOL = 2.0 ** -7    # an f32 leaf (state, logits) of a bf16 run
CPU = torch.device("cpu")


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


@pytest.fixture
def bf16_reference(monkeypatch):
    """The JAX package's own compute dtype, bf16, whatever another test
    module set it to when it was imported."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.bfloat16)


def _configs(pes):
    """Smoke configs of both packages with tp = pes (d_model 128 at 8)."""
    kw = dict(tp=pes)
    if pes == 8:
        kw["d_model"] = 128
    return (dataclasses.replace(jax_get(ARCH).scaled_for_smoke(), **kw),
            dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), **kw))


def _mesh(pes):
    return make_mesh((1, pes), ("data", "model"))


def _bound(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= _bound(ref)



def _close_bf16(got, ref):
    """bf16 in both packages: the leaf's dtype is JAX's; a bf16 leaf holds
    within two bf16 ulps of the largest value, an f32 leaf (the state, the
    logits) within one, both relative to max(1, max|ref|). The two
    packages round their bf16 products apart by an ulp here and there, so
    this catches a wrong dtype or a bf16 path that goes astray, not a cast
    moved by one rounding."""
    ref = np.asarray(ref)
    if got.dtype == torch.bfloat16:
        assert ref.dtype == jnp.bfloat16
        tol = BF16_TOL
    else:
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        tol = BF16_F32_TOL
    got, ref = got.float().numpy(), ref.astype(np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(1.0,
                                                float(np.abs(ref).max()))


# ------------------------------------------------------------ block level
def _rwkv_weights(cfg, seed):
    """Global RWKV time-mix and channel-mix leaves at unit scale (NumPy):
    the decay base of the model's init, data-dependent decay and bonus
    large enough to matter."""
    rng = np.random.RandomState(seed)
    D, F = cfg.d_model, cfg.d_ff
    n = rng.standard_normal
    w = {"ln": 0.1 * n(D), "mu": rng.uniform(0, 1, (5, D)),
         "wr": n((D, D)) / np.sqrt(D), "wk": n((D, D)) / np.sqrt(D),
         "wv": n((D, D)) / np.sqrt(D), "wg": n((D, D)) / np.sqrt(D),
         "w_lora_a": n((D, 64)) / np.sqrt(D), "w_lora_b": 0.05 * n((64, D)),
         "decay_w0": np.linspace(-6.0, -1.0, D), "bonus_u": 0.5 * n(D),
         "wo": n((D, D)) / np.sqrt(D),
         "fln": 0.1 * n(D), "cm_mu": rng.uniform(0, 1, (2, D)),
         "cm_r": n((D, D)) / np.sqrt(D), "cm_k": n((D, F)) / np.sqrt(D),
         "cm_v": n((F, D)) / np.sqrt(F)}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _specs(defs):
    return {k: d.spec for k, d in defs.items()}


def _jax_specs(jcfg, jtopo):
    d = dict(jax_params._rwkv_defs(jcfg, jtopo))
    d.update(jax_params._rwkvcm_defs(jcfg, jtopo))
    return _specs(d)


def _port_weights(pcfg, topo, w, dtype=torch.float32):
    specs = _specs({**_rwkv_defs(pcfg, topo), **_rwkvcm_defs(pcfg, topo)})
    placed = {k: topo.cube.to_cube(torch.from_numpy(w[k]), specs[k])
              for k in specs}
    return blocks.gather_params(placed, specs, topo, dtype)


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _closer(dtype):
    return _close_bf16 if dtype == torch.bfloat16 else _close


@pytest.mark.parametrize("pes", PES)
def test_rwkv_blocks_match_jax(f32_reference, pes):
    """``rwkv_mix`` and ``rwkv_channel_mix`` on sequence-parallel
    activations, with the cache each hands to decode: the final state,
    the last position's normed hidden of each."""
    _blocks_vs_jax(pes, torch.float32)


@pytest.mark.parametrize("pes", PES)
def test_rwkv_blocks_match_jax_bf16(bf16_reference, pes):
    """The same in bf16, JAX's own compute dtype (the state stays f32)."""
    _blocks_vs_jax(pes, torch.bfloat16)


def _blocks_vs_jax(pes, dtype):
    jcfg, pcfg = _configs(pes)
    B, S = 2, 16
    rng = np.random.RandomState(20 + pes)
    w = _rwkv_weights(pcfg, 1)
    x = rng.standard_normal((B, S, pcfg.d_model)).astype(np.float32)
    jtopo = jax_topology(jcfg, _mesh(pes))
    jspecs = _jax_specs(jcfg, jtopo)
    xspec = P(jtopo.dp, jtopo.sp, None)

    def jfn(w_, x_):
        wg = jax_blocks.gather_params(w_, jspecs, jtopo)
        y, (state, shift) = jax_blocks.rwkv_mix(jcfg, jtopo, wg, x_,
                                                out_cache=True)
        z, cm_shift = jax_blocks.rwkv_channel_mix(jcfg, jtopo, wg, y,
                                                  out_cache=True)
        return y, state, shift, z, cm_shift

    outs = jax.jit(shard_map(
        jfn, mesh=jtopo.cube.mesh, in_specs=(jspecs, xspec),
        out_specs=(xspec, P(jtopo.dp, jtopo.tp), P(jtopo.dp), xspec,
                   P(jtopo.dp)), check_vma=False))(
        {k: jnp.asarray(v) for k, v in w.items()},
        jnp.asarray(x).astype(_jax_dtype(dtype)))

    topo = build_topology(pcfg, pes)
    cube = topo.cube
    wp = _port_weights(pcfg, topo, w, dtype)
    xs = (topo.dp, topo.sp, None)
    y, (state, shift) = blocks.rwkv_mix(
        pcfg, topo, wp, cube.to_cube(torch.from_numpy(x).to(dtype), xs),
        out_cache=True)
    z, cm_shift = blocks.rwkv_channel_mix(pcfg, topo, wp, y, out_cache=True)
    got = (cube.from_cube(y, xs), cube.from_cube(state, (topo.dp, topo.tp)),
           cube.from_cube(shift, (topo.dp,)), cube.from_cube(z, xs),
           cube.from_cube(cm_shift, (topo.dp,)))
    assert state.dtype == torch.float32
    for g, ref in zip(got, outs):
        _closer(dtype)(g, ref)


@pytest.mark.parametrize("pes", PES)
def test_rwkv_decode_blocks_match_jax(f32_reference, pes):
    """``rwkv_mix_decode`` and ``rwkv_channel_mix_decode`` from a nonzero
    state and token shifts."""
    _decode_blocks_vs_jax(pes, torch.float32)


@pytest.mark.parametrize("pes", PES)
def test_rwkv_decode_blocks_match_jax_bf16(bf16_reference, pes):
    """The same in bf16, JAX's own compute dtype (the state stays f32)."""
    _decode_blocks_vs_jax(pes, torch.bfloat16)


def _decode_blocks_vs_jax(pes, dtype):
    jcfg, pcfg = _configs(pes)
    B, D = 3, pcfg.d_model
    hd = pcfg.rwkv_head_dim
    rng = np.random.RandomState(40 + pes)
    w = _rwkv_weights(pcfg, 2)
    x, prev, cm_prev = (rng.standard_normal((B, D)).astype(np.float32)
                        for _ in range(3))
    state = rng.standard_normal((B, D // hd, hd, hd)).astype(np.float32)
    jtopo = jax_serve_topology(jcfg, _mesh(pes))
    jspecs = _jax_specs(jcfg, jtopo)
    sspec = P(None, jtopo.tp)

    def jfn(w_, x_, s_, p_, c_):
        wg = jax_blocks.gather_params(w_, jspecs, jtopo)
        y, s1, hn = jax_blocks.rwkv_mix_decode(jcfg, jtopo, wg, x_, s_, p_)
        z, cm = jax_blocks.rwkv_channel_mix_decode(jcfg, jtopo, wg, y, c_)
        return y, s1, hn, z, cm

    outs = jax.jit(shard_map(
        jfn, mesh=jtopo.cube.mesh, in_specs=(jspecs, P(), sspec, P(), P()),
        out_specs=(P(), sspec, P(), P(), P()), check_vma=False))(
        {k: jnp.asarray(v) for k, v in w.items()},
        *(jnp.asarray(a).astype(jnp.float32 if a is state
                                else _jax_dtype(dtype))
          for a in (x, state, prev, cm_prev)))

    topo = build_serve_topology(pcfg, pes)
    cube = topo.cube
    wp = _port_weights(pcfg, topo, w, dtype)
    rep = (None, None)
    ss = (None, topo.tp)
    act = (lambda a: cube.to_cube(torch.from_numpy(a).to(dtype), rep))
    y, s1, hn = blocks.rwkv_mix_decode(
        pcfg, topo, wp, act(x), cube.to_cube(torch.from_numpy(state), ss),
        act(prev))
    z, cm = blocks.rwkv_channel_mix_decode(pcfg, topo, wp, y, act(cm_prev))
    got = (cube.from_cube(y, rep), cube.from_cube(s1, ss),
           cube.from_cube(hn, rep), cube.from_cube(z, rep),
           cube.from_cube(cm, rep))
    for g, ref in zip(got, outs):
        _closer(dtype)(g, ref)


# ------------------------------------------------------------ model level
def _jax_params(jcfg, jtopo, seed):
    return jax_params.init_params(jcfg, jtopo, seed=seed)


def _tokens(cfg, seed, shape):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("pes", PES)
def test_forward_logits_matches_jax(f32_reference, pes):
    _forward_vs_jax(pes, torch.float32)


@pytest.mark.parametrize("pes", PES)
def test_forward_logits_matches_jax_bf16(bf16_reference, pes):
    _forward_vs_jax(pes, torch.bfloat16)


def _forward_vs_jax(pes, dtype):
    jcfg, pcfg = _configs(pes)
    B, S = 2, 16
    tokens = _tokens(jcfg, 3, (B, S))
    jtopo = jax_topology(jcfg, _mesh(pes))
    jparams = _jax_params(jcfg, jtopo, 1)
    fwd = jax.jit(shard_map(
        jax_lm.Model(jcfg, jtopo).forward_logits, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  input_batch_specs(jcfg, jtopo)),
        out_specs=P(jtopo.dp, None, jtopo.tp), check_vma=False))
    ref = fwd(jparams, {"tokens": jnp.asarray(tokens),
                        "labels": jnp.asarray(tokens)})

    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    cube = topo.cube
    logits = Model(pcfg, topo, dtype=dtype).forward_logits(
        params, {"tokens": cube.to_cube(torch.from_numpy(tokens).long(),
                                        (topo.dp, None))})
    _closer(dtype)(cube.from_cube(logits, (topo.dp, None, topo.tp)), ref)


def _jax_decode(jcfg, pes, S_ctx, B, jparams=None):
    jtopo = jax_serve_topology(jcfg, _mesh(pes))
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S_ctx,
                                        global_batch=B)
    if jparams is None:
        jparams = _jax_params(jcfg, jtopo, 2)
    cspecs = jax_serving.cache_specs(jcfg, jtopo, jplan)
    jba = jplan.batch_axes or None
    jstep = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, jplan).decode_shard,
        mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo), cspecs, P(jba),
                  P(jba)),
        out_specs=(P(jba, jtopo.tp), cspecs), check_vma=False))
    return jtopo, jplan, jparams, jstep


@pytest.mark.parametrize("pes", PES)
def test_decode_matches_jax_on_launcher_loop(f32_reference, pes):
    """The launcher's loop -- teacher-forced prompt, then greedy -- through
    the JAX ``decode_shard`` and the port's, step by step; the port's
    cache leaves (written in place) track the JAX cache."""
    _decode_loop_vs_jax(pes, torch.float32)


@pytest.mark.parametrize("pes", PES)
def test_decode_matches_jax_on_launcher_loop_bf16(bf16_reference, pes):
    """The same in bf16 (the state stays f32, the shifts are bf16). Both
    packages feed the JAX loop's tokens: a greedy pick may break a bf16
    tie the other way."""
    _decode_loop_vs_jax(pes, torch.bfloat16)


def _decode_loop_vs_jax(pes, dtype):
    jcfg, pcfg = _configs(pes)
    B, prompt_len, gen = 2, 5, 4
    S_ctx = prompt_len + gen
    prompt = _tokens(jcfg, 4, (B, prompt_len))
    jtopo, jplan, jparams, jstep = _jax_decode(jcfg, pes, S_ctx, B)
    jcache = jax_serving.init_cache(jcfg, jtopo, jplan)

    topo = build_serve_topology(pcfg, pes)
    plan = make_serve_plan(pcfg, topo, S_ctx=S_ctx, global_batch=B)
    for f in dataclasses.fields(plan):
        assert getattr(plan, f.name) == getattr(jplan, f.name), f.name
    server = Server(pcfg, topo, plan, dtype=dtype)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    cache = init_cache(pcfg, topo, plan, dtype=dtype, device=CPU)
    assert cache["p0"]["state"].dtype == torch.float32
    cube = topo.cube
    ba = plan.batch_axes or None
    cspecs = jax_serving.cache_specs(jcfg, jtopo, jplan)

    toks = prompt[:, 0]
    for t in range(S_ctx - 1):
        pos = np.full((B,), t, np.int32)
        ref, jcache = jstep(jparams, jcache, jnp.asarray(toks),
                            jnp.asarray(pos))
        logits, cache = server.decode_shard(
            params, cache, cube.to_cube(torch.from_numpy(toks).long(), (ba,)),
            cube.to_cube(torch.from_numpy(pos).long(), (ba,)))
        got = cube.from_cube(logits, (ba, topo.tp))
        _closer(dtype)(got, ref)
        nxt = np.asarray(ref.astype(jnp.float32)).argmax(-1)
        if dtype == torch.float32:
            np.testing.assert_array_equal(got.numpy().argmax(-1), nxt)
        toks = prompt[:, t + 1] if t + 1 < prompt_len else nxt
    for k, leaf in cache["p0"].items():
        _closer(dtype)(cube.from_cube(leaf, tuple(cspecs["p0"][k])),
                       jcache["p0"][k])


def _prefill_cache_specs(jtopo):
    dp, tp = jtopo.dp, jtopo.tp
    return {"p0": {"state": P(None, dp, tp, None, None),
                   "shift": P(None, dp, None),
                   "cm_shift": P(None, dp, None)}}


@pytest.mark.parametrize("pes", PES)
def test_prefill_matches_jax(f32_reference, pes):
    """``prefill_shard``'s last-position logits and its cache (the final
    state, shift and cm_shift of every layer) against the JAX prefill on
    its training-style topology, which here is the serve topology's
    cube."""
    _prefill_vs_jax(pes, torch.float32)


@pytest.mark.parametrize("pes", PES)
def test_prefill_matches_jax_bf16(bf16_reference, pes):
    _prefill_vs_jax(pes, torch.bfloat16)


def _prefill_vs_jax(pes, dtype):
    jcfg, pcfg = _configs(pes)
    B, S = 2, 16
    tokens = _tokens(jcfg, 6, (B, S))
    jtopo = jax_topology(jcfg, _mesh(pes))
    jparams = _jax_params(jcfg, jtopo, 3)
    cspec = _prefill_cache_specs(jtopo)
    pre = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, None).prefill_shard,
        mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  {"tokens": P(jtopo.dp, None)}),
        out_specs=(P(jtopo.dp, jtopo.tp), cspec), check_vma=False))
    ref, jcache = pre(jparams, {"tokens": jnp.asarray(tokens)})

    topo = build_serve_topology(pcfg, pes)
    assert topo.cube == build_topology(pcfg, pes).cube
    plan = make_serve_plan(pcfg, topo, S_ctx=S + 4, global_batch=B)
    server = Server(pcfg, topo, plan, dtype=dtype)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    cube = topo.cube
    logits, cache = server.prefill_shard(
        params, {"tokens": cube.to_cube(torch.from_numpy(tokens).long(),
                                        (topo.dp, None))})
    _closer(dtype)(cube.from_cube(logits, (topo.dp, topo.tp)), ref)
    # the cache has init_cache's layout, so decode takes it as it is
    zeros = init_cache(pcfg, topo, plan, dtype=dtype, device=CPU)
    specs = {"state": (None, None, topo.tp), "shift": (), "cm_shift": ()}
    for k, leaf in cache["p0"].items():
        assert leaf.shape == zeros["p0"][k].shape
        assert leaf.dtype == zeros["p0"][k].dtype
        _closer(dtype)(cube.from_cube(leaf, specs[k]), jcache["p0"][k])


def test_bf16_drift_from_f32_matches_jax_at_depth():
    """32 layers at d_model 512 (8 heads of 64): bf16 rounding grows with
    depth, and the port's bf16 forward lies as far from its f32 forward as
    the JAX package's bf16 lies from JAX's f32 (within a factor of 1.5
    either way), while the two f32 forwards agree to 1e-4. The full-width
    model's bf16 logits on the card sit about a third of their largest
    value from f32; this shows the reference drifts the same way."""
    kw = dict(n_layers=32, d_model=512, rwkv_head_dim=64, d_ff=1792,
              vocab_size=4096, tp=1)
    jcfg = dataclasses.replace(jax_get(ARCH).scaled_for_smoke(), **kw)
    pcfg = dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), **kw)
    tokens = _tokens(jcfg, 3, (2, 32))
    jtopo = jax_topology(jcfg, _mesh(1))
    topo = build_topology(pcfg, 1)
    out = {}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        with pytest.MonkeyPatch.context() as mp:
            for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
                mp.setattr(mod, "COMPUTE_DTYPE", jdt)
            jparams = _jax_params(jcfg, jtopo, 1)
            fwd = jax.jit(shard_map(
                jax_lm.Model(jcfg, jtopo).forward_logits,
                mesh=jtopo.cube.mesh,
                in_specs=(jax_params.param_specs(jcfg, jtopo),
                          input_batch_specs(jcfg, jtopo)),
                out_specs=P(jtopo.dp, None, jtopo.tp), check_vma=False))
            ref = fwd(jparams, {"tokens": jnp.asarray(tokens),
                                "labels": jnp.asarray(tokens)})
        params = from_jax_params(pcfg, topo,
                                 jax.tree.map(np.asarray, jparams),
                                 device=CPU)
        got = Model(pcfg, topo, dtype=tdt).forward_logits(
            params, {"tokens": topo.cube.to_cube(
                torch.from_numpy(tokens).long(), (topo.dp, None))})
        out[tdt] = (np.asarray(ref.astype(jnp.float32)),
                    topo.cube.from_cube(got, (topo.dp, None, topo.tp))
                    .float().numpy())
    (j32, t32), (jb, tb) = out[torch.float32], out[torch.bfloat16]
    assert np.abs(t32 - j32).max() <= _bound(j32)
    jax_drift = float(np.abs(jb - j32).max())
    port_drift = float(np.abs(tb - t32).max())
    print(f"bf16 drift from f32 over 32 layers: JAX {jax_drift:.6g}, port "
          f"{port_drift:.6g}, max|f32 logit| {np.abs(j32).max():.6g}")
    assert jax_drift / 1.5 <= port_drift <= 1.5 * jax_drift


def _step(server, params, cache, toks, t):
    """One decode step of every request at position t; global logits."""
    cube, tp = server.topo.cube, server.topo.tp
    pos = torch.full(toks.shape, t)
    logits, _ = server.decode_shard(params, cache,
                                    cube.to_cube(toks, (None,)),
                                    cube.to_cube(pos, (None,)))
    return cube.from_cube(logits, (None, tp))


@pytest.mark.parametrize("pes", PES)
def test_prefill_then_decode_equals_teacher_forced_loop(pes):
    """Prefill of the prompt, then decode from its cache, against the
    launcher's loop (teacher-forced prompt through decode steps, then
    greedy): the logits at the prompt's last position, every greedy token,
    and the cache the loop holds after the prompt."""
    _, pcfg = _configs(pes)
    B, prompt_len, gen = 2, 8, 5
    topo = build_serve_topology(pcfg, pes)
    plan = make_serve_plan(pcfg, topo, S_ctx=prompt_len + gen,
                           global_batch=B)
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = init_params(pcfg, topo, 11, device=CPU)
    toks = torch.from_numpy(_tokens(pcfg, 12, (B, prompt_len))).long()
    loop = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
    ref_logits, ref_tokens = [], []
    nxt = None
    for t in range(prompt_len + gen - 1):
        lg = _step(server, params, loop,
                   toks[:, t] if t < prompt_len else nxt, t)
        if t == prompt_len - 1:
            after_prompt = {k: v.clone() for k, v in loop["p0"].items()}
            ref_logits = lg
        if t >= prompt_len - 1:
            nxt = lg.argmax(-1)
            ref_tokens.append(nxt)

    logits, cache = server.prefill_shard(
        params, {"tokens": topo.cube.to_cube(toks, (topo.dp, None))})
    for k, want in after_prompt.items():
        got = cache["p0"][k]
        assert float((got - want).abs().max()) <= TOL * max(
            1.0, float(want.abs().max())), k
    last = topo.cube.from_cube(logits, (None, topo.tp))
    assert float((last - ref_logits).abs().max()) <= TOL * max(
        1.0, float(ref_logits.abs().max()))
    out = [last.argmax(-1)]
    for t in range(prompt_len, prompt_len + gen - 1):
        out.append(_step(server, params, cache, out[-1], t).argmax(-1))
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(),
                                  torch.stack(ref_tokens, 1).numpy())


def test_from_jax_params_carries_rwkv_weights():
    jcfg, pcfg = _configs(8)
    jtopo = jax_serve_topology(jcfg, _mesh(8))
    jparams = jax.tree.map(np.asarray,
                           jax_params.init_params(jcfg, jtopo, seed=5))
    topo = build_serve_topology(pcfg, 8)
    params = from_jax_params(pcfg, topo, jparams, device=CPU)
    specs = param_specs(pcfg, topo)
    unit = params["units"]["p0"]
    assert set(unit) == set(jparams["units"]["p0"])
    assert {"decay_w0", "bonus_u", "w_lora_a", "cm_r", "cm_k"} <= set(unit)
    for k, leaf in unit.items():
        np.testing.assert_array_equal(
            topo.cube.from_cube(leaf, specs["units"]["p0"][k]).numpy(),
            jparams["units"]["p0"][k], err_msg=k)
    # head block of PE 3 under 8-way tp
    Dl = pcfg.d_model // 8
    np.testing.assert_array_equal(
        unit["decay_w0"][0, 3].numpy(),
        jparams["units"]["p0"]["decay_w0"][:, 3 * Dl:4 * Dl])


def test_decay_init_does_not_depend_on_the_cube():
    """Every leaf, the ``decay`` one included, holds the same global values
    on 1 and 8 PEs; the decay base is the JAX init's linspace."""
    _, cfg = _configs(8)
    trees = []
    for pes in (1, 8):
        topo = build_serve_topology(cfg, pes)
        params = init_params(cfg, topo, 3, device=CPU)
        specs = param_specs(cfg, topo)
        trees.append({k: topo.cube.from_cube(v, specs["units"]["p0"][k])
                      for k, v in params["units"]["p0"].items()})
    for k in trees[0]:
        torch.testing.assert_close(trees[0][k], trees[1][k], rtol=0, atol=0)
    jd = np.asarray(jax_params._init_leaf(
        None, jax_params.ParamDef((cfg.n_layers, cfg.d_model), P(),
                                  "decay"), cfg))
    np.testing.assert_allclose(trees[0]["decay_w0"].numpy(), jd, atol=1e-6)


def test_launcher_serves_rwkv_on_the_cpu(capsys):
    run = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--pes", "4"])
    out = capsys.readouterr().out
    assert "rwkv6 kernel launches=0" in out and "ms/step" in out
    assert run["tokens"].shape == (4, 48)
    assert str(run["topo"].cube.describe()).startswith(
        "Hypercube[data=1,tp=4")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.cuda
def test_model_paths_launch_the_kernel_on_the_card():
    """On the card, a forward and a prefill launch the RWKV6 kernel once
    per layer each and agree with the CPU's plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    _, cfg = _configs(8)
    B, S = 2, 16
    tokens = torch.from_numpy(_tokens(cfg, 8, (B, S))).long()
    got = {}
    for dev in ("cpu", "cuda"):
        topo = build_serve_topology(cfg, 8)
        plan = make_serve_plan(cfg, topo, S_ctx=S, global_batch=B)
        params = init_params(cfg, topo, 4, device=CPU)
        params = _to(params, dev)
        batch = {"tokens": topo.cube.to_cube(tokens.to(dev),
                                             (topo.dp, None))}
        n0 = rwkv6.LAUNCHES
        fwd = Model(cfg, topo, dtype=torch.float32).forward_logits(params,
                                                                   batch)
        pre, _ = Server(cfg, topo, plan, dtype=torch.float32).prefill_shard(
            params, batch)
        n = rwkv6.LAUNCHES - n0
        assert n == (0 if dev == "cpu" else 2 * cfg.n_layers)
        got[dev] = (fwd.cpu(), pre.cpu())
    for a, b in zip(got["cpu"], got["cuda"]):
        assert float((a - b).abs().max()) <= TOL * max(
            1.0, float(a.abs().max()))
