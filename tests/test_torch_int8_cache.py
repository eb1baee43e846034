"""The port's int8 KV cache (``make_serve_plan(cache_dtype="int8")``: int8
codes and an f32 scale a (slot, kv head), the paper's §V-C 8-bit layout)
held against the JAX package on the CPU.

Both packages decode the launcher's loop (teacher-forced prompt, then
greedy) in f32 (the JAX compute dtype set with ``monkeypatch``), on the same
weights (JAX's ``init_params`` carried across with ``from_jax_params``):
the logits within 1e-4 x max(1, max|JAX|) at every step, the greedy tokens
identical, and after the loop the caches: the int8 codes equal to JAX's on
at least 99.9% of the entries and one step apart on the rest (a quotient
within an ulp of a half rounds either way), the scales within 1e-6
relative. The worst logits difference seen (printed under ``-s``) was
1.49e-7 at 1 PE and 1.79e-7 at 2 and 4 PEs, with max|logits| about 0.6.

In bf16 at qwen3's full depth (28 layers, narrower widths), the int8
cache's logits lie as far from the bf16 cache's in the port as in JAX
(within 1.5x): 0.023 / 0.030 of max(1, max|logits|) in the port, 0.020 /
0.034 in JAX, at d_model 512 / 1024.

The paged int8 cell against the contiguous one within 1e-5, as
``tests/test_paging.py`` holds JAX's; the plain int8 decode form against
``ref.flash_attention`` on the dequantized cache; the kernel itself on the
card (``-m cuda``).
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
from repro.models.topology import build_serve_topology as jax_serve_topology

from repro_torch import configs
from repro_torch.kernels.attention import flash, ops, ref
from repro_torch.models import blocks
from repro_torch.models.params import from_jax_params, init_params
from repro_torch.models.serving import (
    Server, cache_defs, init_cache, make_serve_plan)
from repro_torch.models.topology import build_serve_topology
from repro_torch.serving.pages import (
    PagedServer, PageTable, init_paged_cache, make_page_plan)

ARCH = "qwen3-1.7b"
TOL = 1e-4          # port vs JAX logits, f32, x max(1, max|JAX|)
PAGED_TOL = 1e-5    # paged vs contiguous int8 (tests/test_paging.py)
CODES_EQUAL = 0.999  # share of int8 codes equal to JAX's
SCALE_TOL = 1e-6    # relative
CPU = torch.device("cpu")


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


@pytest.fixture
def bf16_reference(monkeypatch):
    """The JAX package's compute in bf16, its default: pinned, because
    ``tests/test_serving.py`` sets it to f32 in three modules on import."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.bfloat16)


def _configs(pes):
    return (dataclasses.replace(jax_get(ARCH).scaled_for_smoke(), tp=pes),
            dataclasses.replace(configs.get(ARCH).scaled_for_smoke(),
                                tp=pes))


def test_make_serve_plan_rejects_other_cache_dtypes():
    cfg = configs.get(ARCH).scaled_for_smoke()
    topo = build_serve_topology(cfg, 1)
    with pytest.raises(ValueError, match="bf16.*int8"):
        make_serve_plan(cfg, topo, S_ctx=8, global_batch=2,
                        cache_dtype="fp8")
    plan = make_serve_plan(cfg, topo, S_ctx=8, global_batch=2,
                           cache_dtype="int8")
    d = cache_defs(cfg, topo, plan, torch.float32)["p0"]
    assert d["k"][2] == d["v"][2] == torch.int8
    assert d["k_s"][0] == d["v_s"][0] == (cfg.n_layers, 2, 8,
                                          cfg.n_kv_heads)
    assert d["k_s"][2] == torch.float32


def _norm(spec) -> tuple:
    """A spec with one-name tuples as the name (JAX's PartitionSpec form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def test_cache_defs_match_jax_int8():
    """The int8 cache tree's leaves, shapes and specs equal JAX's."""
    jcfg, pcfg = _configs(2)
    jtopo = jax_serve_topology(jcfg, make_mesh((1, 2), ("data", "model")))
    topo = build_serve_topology(pcfg, 2)
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=12,
                                        global_batch=2, cache_dtype="int8")
    plan = make_serve_plan(pcfg, topo, S_ctx=12, global_batch=2,
                           cache_dtype="int8")
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    jd = jax_serving.cache_defs(jcfg, jtopo, jplan)
    pd = cache_defs(pcfg, topo, plan)
    assert sorted(jd["p0"]) == sorted(pd["p0"]) == ["k", "k_s", "v", "v_s"]
    for k in jd["p0"]:
        assert jd["p0"][k][0] == pd["p0"][k][0]
        assert _norm(jd["p0"][k][1]) == _norm(pd["p0"][k][1])


def _global(topo, plan, leaf):
    spec = (None, plan.batch_axes or None, plan.kv_axes) \
        + (None,) * (leaf.dim() - topo.cube.ndim - 3)
    return topo.cube.from_cube(leaf, spec).numpy()


@pytest.mark.parametrize("pes", [1, 2, 4])
def test_int8_decode_matches_jax(f32_reference, pes, capsys):
    jcfg, pcfg = _configs(pes)
    B, prompt_len, gen = 2, 8, 4
    S_ctx = prompt_len + gen
    prompt = np.random.RandomState(4).randint(0, jcfg.vocab_size,
                                              (B, prompt_len))
    jtopo = jax_serve_topology(jcfg, make_mesh((1, pes), ("data", "model")))
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S_ctx,
                                        global_batch=B, cache_dtype="int8")
    jparams = jax_params.init_params(jcfg, jtopo, seed=2)
    jcache = jax_serving.init_cache(jcfg, jtopo, jplan)
    cspecs = jax_serving.cache_specs(jcfg, jtopo, jplan)
    jba = jplan.batch_axes or None
    jstep = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, jplan).decode_shard,
        mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo), cspecs, P(jba),
                  P(jba)),
        out_specs=(P(jba, jtopo.tp), cspecs), check_vma=False))

    topo = build_serve_topology(pcfg, pes)
    plan = make_serve_plan(pcfg, topo, S_ctx=S_ctx, global_batch=B,
                           cache_dtype="int8")
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    cache = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
    cube = topo.cube
    ba = plan.batch_axes or None

    toks, worst, top = prompt[:, 0], 0.0, 0.0
    for t in range(S_ctx - 1):
        pos = np.full((B,), t, np.int32)
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(pos))
        want = np.asarray(want)
        logits, cache = server.decode_shard(
            params, cache, cube.to_cube(torch.from_numpy(toks).long(), (ba,)),
            cube.to_cube(torch.from_numpy(pos).long(), (ba,)))
        got = cube.from_cube(logits, (ba, topo.tp)).numpy()
        err = float(np.abs(got - want).max())
        assert err <= TOL * max(1.0, float(np.abs(want).max())), t
        worst, top = max(worst, err), max(top, float(np.abs(want).max()))
        nxt = want.argmax(-1)
        np.testing.assert_array_equal(got.argmax(-1), nxt)
        toks = prompt[:, t + 1] if t + 1 < prompt_len else nxt
    with capsys.disabled():
        print(f"\nint8 decode vs JAX at {pes} PEs: max |diff| {worst:.3g}, "
              f"max |logits| {top:.3g}")

    for key in ("k", "v"):
        got = _global(topo, plan, cache["p0"][key]).astype(np.int32)
        want = np.asarray(jcache["p0"][key]).astype(np.int32)
        assert got.shape == want.shape
        assert (got == want).mean() >= CODES_EQUAL
        assert np.abs(got - want).max() <= 1
        s_got = _global(topo, plan, cache["p0"][key + "_s"])
        s_want = np.asarray(jcache["p0"][key + "_s"])
        assert s_got.dtype == s_want.dtype == np.float32
        assert np.abs(s_got - s_want).max() <= SCALE_TOL * np.abs(
            s_want).max()
        assert (s_want[:, :, :S_ctx - 1] > 0).all()   # every slot written


def _teacher_forced(jcfg, pcfg, tokens, cache_dtype):
    """Both packages' decode of ``tokens`` (B, S), every step teacher-forced,
    at 1 PE in bf16 (``bf16_reference``) from the
    ``cache_dtype`` cache, on JAX's weights from seed 3: each package's
    logits (B, S - 1, V) in f32."""
    B, S = tokens.shape
    jtopo = jax_serve_topology(jcfg, make_mesh((1, 1), ("data", "model")))
    jparams = jax_params.init_params(jcfg, jtopo, seed=3)
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S, global_batch=B,
                                        cache_dtype=cache_dtype)
    cspecs = jax_serving.cache_specs(jcfg, jtopo, jplan)
    jstep = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, jplan).decode_shard,
        mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo), cspecs, P(None),
                  P(None)),
        out_specs=(P(None, jtopo.tp), cspecs), check_vma=False))
    jcache = jax_serving.init_cache(jcfg, jtopo, jplan)
    topo = build_serve_topology(pcfg, 1)
    plan = make_serve_plan(pcfg, topo, S_ctx=S, global_batch=B,
                           cache_dtype=cache_dtype)
    server = Server(pcfg, topo, plan, dtype=torch.bfloat16)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    cache = init_cache(pcfg, topo, plan, dtype=torch.bfloat16, device=CPU)
    cube = topo.cube
    jout, pout = [], []
    for t in range(S - 1):
        lg, jcache = jstep(jparams, jcache,
                           jnp.asarray(tokens[:, t], jnp.int32),
                           jnp.full((B,), t, jnp.int32))
        jout.append(np.asarray(lg.astype(jnp.float32)))
        lg, cache = server.decode_shard(
            params, cache, cube.to_cube(torch.from_numpy(tokens[:, t]),
                                        (None,)),
            cube.to_cube(torch.full((B,), t), (None,)))
        pout.append(cube.from_cube(lg, (None, topo.tp)).float().numpy())
    return np.stack(jout, 1), np.stack(pout, 1)


@pytest.mark.parametrize("d_model", [512, 1024])
def test_int8_gap_in_bf16_matches_jax_at_depth(bf16_reference, d_model,
                                               capsys):
    """qwen3 at its full depth (28 layers), head_dim 128 and G = 2, at
    ``d_model`` (d_model / 128 heads), in bf16 over 47 teacher-forced steps
    of 4 requests: the int8 cache's logits lie as far from the bf16
    cache's in the port as in the JAX package (within a factor of 1.5
    either way). Printed under ``-s``: both packages' gap over max(1,
    max|logits|), which grows with the width in both (the full width is
    not run on the CPU)."""
    H = d_model // 128
    kw = dict(n_layers=28, d_model=d_model, n_heads=H, n_kv_heads=H // 2,
              head_dim=128, d_ff=3 * d_model, vocab_size=4096, tp=1)
    jcfg = dataclasses.replace(jax_get(ARCH).scaled_for_smoke(), **kw)
    pcfg = dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), **kw)
    tokens = np.random.RandomState(5).randint(0, jcfg.vocab_size, (4, 48))
    jb, pb = _teacher_forced(jcfg, pcfg, tokens, "bf16")
    j8, p8 = _teacher_forced(jcfg, pcfg, tokens, "int8")
    assert np.isfinite(p8).all() and np.isfinite(pb).all()
    jax_gap = float(np.abs(j8 - jb).max()) / max(1.0, float(np.abs(jb).max()))
    port_gap = float(np.abs(p8 - pb).max()) / max(1.0,
                                                  float(np.abs(pb).max()))
    with capsys.disabled():
        print(f"\nint8 vs bf16 cache in bf16, 28 layers, d_model {d_model}: "
              f"JAX {jax_gap:.6g}, port {port_gap:.6g} x max(1, max|logits|)"
              f" (max|logits| {float(np.abs(jb).max()):.6g})")
    assert jax_gap / 1.5 <= port_gap <= 1.5 * jax_gap


def test_quantize_kv_as_the_reference():
    """Scale max(absmax, 1e-6) / 127, codes round-half-even of x / scale:
    a zero row keeps scale 1e-6 / 127 and codes 0; the codes of the
    absmax entry are +-127; half-way quotients round to even."""
    x = torch.tensor([[0.0, 0.0, 0.0, 0.0],
                      [1.0, -2.0, 0.5, 127.0],
                      [2.5 / 127, -1.5 / 127, 1.0 / 127, 0.5 / 127]])
    q, s = blocks.quantize_kv(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert float(s[0]) == pytest.approx(1e-6 / 127, rel=1e-6)
    assert q[0].tolist() == [0, 0, 0, 0]
    assert q[1].tolist() == [1, -2, 0, 127]           # 0.5 rounds to 0
    assert q[2].tolist() == [127, -76, 51, 25]        # x / (2.5/127/127)
    # the reference's formula in NumPy on the same rows
    xs = x.numpy()
    sc = np.maximum(np.abs(xs).max(-1), 1e-6) / 127.0
    np.testing.assert_array_equal(q.numpy(),
                                  np.round(xs / sc[:, None]).astype(np.int8))


def _paged_vs_contiguous(tp, S=16, B=2):
    cfg = dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), tp=tp)
    topo = build_serve_topology(cfg, tp)
    plan = make_serve_plan(cfg, topo, S_ctx=S, global_batch=B,
                           cache_dtype="int8")
    pplan = make_page_plan(plan, topo, page_size=4)
    params = init_params(cfg, topo, 1, device=CPU)
    server = Server(cfg, topo, plan)
    paged = PagedServer(server, pplan)
    cache = init_cache(cfg, topo, plan, device=CPU)
    pcache = init_paged_cache(cfg, topo, plan, pplan, device=CPU)
    assert pcache["p0"]["k"].dtype == torch.int8
    assert pcache["p0"]["k_s"].dtype == torch.float32
    tbl = PageTable(pplan, B)
    kvc, cube = topo.comm(plan.kv_axes), topo.cube
    tokens = torch.from_numpy(
        np.random.RandomState(7).randint(0, cfg.vocab_size, (B, S)))
    worst = 0.0
    for t in range(S):
        for b in range(B):
            assert tbl.ensure(b, t % plan.S_cache)
        pos = cube.to_cube(torch.full((B,), t), (None,))
        tok = cube.to_cube(tokens[:, t], (None,))
        want, cache = server.decode_shard(params, cache, tok, pos)
        got, pcache = paged.decode_shard(params, pcache,
                                         kvc.broadcast(tbl.array()), tok, pos)
        assert torch.isfinite(got).all()
        worst = max(worst, float((got - want).abs().max()))
    return worst


@pytest.mark.parametrize("tp", [1, 2])
def test_paged_int8_close_to_contiguous(tp):
    """The quantization happens on identical values in both cells, so the
    paged int8 decode stays within 1e-5 of the contiguous one (bf16)."""
    assert _paged_vs_contiguous(tp) < PAGED_TOL


def _int8_inputs(seed, B, Sq, Sk, H, KV, hd, dtype):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=gen).to(dtype)
    kq, ks = blocks.quantize_kv(torch.randn((B, Sk, KV, hd), generator=gen))
    vq, vs = blocks.quantize_kv(torch.randn((B, Sk, KV, hd), generator=gen))
    ks[:, 0] = 1e-6 / 127        # a zero key
    kq[:, 0] = 0
    return q, kq, vq, ks, vs


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("G,hd,window", [(1, 64, -1), (2, 128, 5),
                                         (6, 128, -1), (8, 256, 3)])
def test_plain_int8_decode_is_dequantize_then_attend(G, hd, window,
                                                     partial):
    """``ops.flash_attention`` with scales on the CPU (the plain int8
    decode form) equals ``ref.flash_attention`` on the dequantized K/V."""
    B, Sk, KV = 2, 19, 2
    q, kq, vq, ks, vs = _int8_inputs(0, B, 1, Sk, G * KV, KV, hd,
                                     torch.float32)
    q_pos = torch.full((B, 1), Sk - 3, dtype=torch.int32)
    k_pos = torch.arange(Sk, dtype=torch.int32).expand(B, Sk).contiguous()
    got = ops.flash_attention(q, kq, vq, q_pos, k_pos, window=window,
                              partial=partial, k_scale=ks, v_scale=vs)
    want = ref.flash_attention(q, kq.float() * ks[..., None],
                               vq.float() * vs[..., None], q_pos, k_pos,
                               window=window, partial=partial)
    for g, w in zip(got if partial else (got,), want if partial else (want,)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_int8_cache_is_decode_only():
    """More than 8 rows a kv head (a forward) over an int8 cache raises in
    the dispatch and in the kernel's geometry; so does prefill into an int8
    plan."""
    q, kq, vq, ks, vs = _int8_inputs(0, 1, 3, 8, 6, 2, 64, torch.float32)
    pos = torch.zeros((1, 3), dtype=torch.int32)
    k_pos = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="decode"):
        ops.flash_attention(q, kq, vq, pos, k_pos, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="decode"):
        flash.launch_geometry(1, 3, 8, 6, 2, 64, torch.float32, torch.int8)
    assert flash._check_layout(q[:, :1], kq, vq, pos[:, :1], k_pos, ks,
                               vs).form == "decode"
    with pytest.raises(TypeError, match="int8"):
        flash._check_layout(q[:, :1], kq.float(), vq.float(), pos[:, :1],
                            k_pos, ks, vs)
    cfg = configs.get(ARCH).scaled_for_smoke()
    topo = build_serve_topology(cfg, 1)
    plan = make_serve_plan(cfg, topo, S_ctx=8, global_batch=1,
                           cache_dtype="int8")
    server = Server(cfg, topo, plan, dtype=torch.float32)
    params = init_params(cfg, topo, 0, device=CPU)
    with pytest.raises(ValueError, match="int8"):
        server.prefill_shard(params, {"tokens": topo.cube.to_cube(
            torch.zeros((1, 4), dtype=torch.long), (None, None))})


@pytest.mark.parametrize("hd,lanes", [(16, 2), (64, 4), (96, 8), (128, 8),
                                      (256, 16)])
def test_int8_decode_geometry(hd, lanes):
    """16 codes a lane: a key's lane group and the keys a CTA step takes;
    long caches split over a cluster as the bf16 form does."""
    assert flash.decode_lanes(hd, torch.int8) == lanes
    geo = flash.launch_geometry(4, 1, 4096, 16, 8, hd, torch.bfloat16,
                                torch.int8)
    assert geo.form == "decode" and geo.key_splits == 8
    assert geo.key_tile == 32 // lanes * flash.DECODE_WARPS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,hd,Sk,window", [(1, 64, 37, -1), (2, 128, 48, 16),
                                            (6, 128, 600, -1),
                                            (8, 256, 2100, 300)])
def test_int8_kernel_matches_plain_version_on_the_card(dtype, G, hd, Sk,
                                                       window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, kq, vq, ks, vs = (t.cuda() for t in _int8_inputs(
        1, 3, 1, Sk, 2 * G, 2, hd, dt))
    q_pos = torch.full((3, 1), Sk - 1, dtype=torch.int32, device="cuda")
    k_pos = torch.arange(Sk, dtype=torch.int32, device="cuda").expand(
        3, Sk).contiguous()
    before = flash.INT8_LAUNCHES
    got = ops.flash_attention(q, kq, vq, q_pos, k_pos, window=window,
                              partial=True, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert flash.INT8_LAUNCHES == before + 1
    want = ref.flash_attention(q, kq, vq, q_pos, k_pos, window=window,
                               partial=True, k_scale=ks, v_scale=vs)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= tol * max(1.0,
                                                      float(w.abs().max()))
