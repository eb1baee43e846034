"""The port's prefill of attention layers and its "sort" MoE dispatch, held
against the JAX package and against the port's own decode loop on the CPU.

``prefill_shard`` against JAX's ``Server.prefill_shard`` (run under
``shard_map(..., check_vma=False)`` on the CPU's virtual devices, on the
same weights and NumPy-seeded tokens, both packages in f32): the last
position's logits, and the K/V cache. The two caches differ in layout by
design: JAX's leaves each PE its slice of the sequence with its own KV
heads, the port's is the decode layout (slots sequence-sharded over tp,
every KV head). So each JAX PE's slice is compared with the same
(positions, heads) of the port's cache reassembled globally; at 1 PE that
is the whole cache. Bound 1e-5 * max(1, max|ref|).

Prefill followed by decode from its cache against the launcher's
teacher-forced loop (the prompt one token a step through ``decode_shard``,
then greedy), at 1, 2, 4 and 8 PEs where the config's heads split: the
last logits, the cache the loop holds after the prompt, every later
step's logits (1e-4 * max(1, max|ref|)) and every greedy token. gemma3 has
12 layers (layers 5 and 11 global) and a prompt past its smoke window of
8; mixtral's smoke window of 8 is shorter than its 12-token prompt, so
prefill fills a rolling cache whose slots decode reads. An MoE layer in
the loop routes one token a step, with an expert capacity per step, and
in prefill the whole prompt at once: the MoE cells run at a capacity
factor at which neither drops a choice, so both compute the same function.

The "sort" dispatch against JAX's ``moe_ffn`` under "sort" (outputs, aux
loss, top-k ids), and against the port's "scatter" bit for bit, on batches
whose repeated tokens overflow an expert's capacity.
"""
import dataclasses
import math

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
from repro.models.topology import build_topology as jax_topology

from repro_torch import configs
from repro_torch.models import blocks
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    _moe_ffn_defs, from_jax_params, init_params)
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology

JAX_TOL = 1e-5      # port vs JAX prefill, f32, x max(1, max|ref|)
LOOP_TOL = 1e-4     # prefill + decode vs the decode loop, f32
CPU = torch.device("cpu")
NO_DROP = 16.0      # a capacity factor at which no expert overflows here

# (arch, overrides of its smoke config); "moe" cells set ep / etp per PEs
CELLS = {
    "qwen3": ("qwen3-1.7b", {}),
    "qwen2_moe": ("qwen2-moe-a2.7b", {"capacity_factor": NO_DROP}),
    "phi3": ("phi3-mini-3.8b", {}),
    "gemma3": ("gemma3-1b", {"n_layers": 12}),
    "mixtral": ("mixtral-8x7b", {"capacity_factor": NO_DROP}),
    # internlm2's G = 6: at 4 PEs KV < tp, 3 query heads a PE
    "internlm2": ("internlm2-20b", {"n_heads": 12, "n_kv_heads": 2}),
}


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def _over(arch, over, pes):
    """Smoke overrides at ``pes`` PEs: tp = pes, or ep * etp = pes (ep up to
    the 4 smoke experts); 8 heads at 8 PEs, where the stock 4 leave a PE
    none."""
    over = dict(over)
    base = configs.get(arch).scaled_for_smoke()
    if base.n_experts:
        ep = min(pes, base.n_experts)
        over.update(ep=ep, etp=pes // ep)
    else:
        over["tp"] = pes
    if pes > base.n_heads:
        over["n_heads"] = pes
    return over


def _configs(cell, pes):
    arch, over = CELLS[cell]
    over = _over(arch, over, pes)
    return (dataclasses.replace(jax_get(arch).scaled_for_smoke(), **over),
            dataclasses.replace(configs.get(arch).scaled_for_smoke(), **over))


def _bound(ref, tol):
    return tol * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _tokens(cfg, seed, shape):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


def _global_kv(topo, plan, leaf):
    """A cache leaf (*cube, n_units, B_l, S_loc, KV, hd) as one global
    (n_units, B, S_cache, KV, hd) tensor."""
    return topo.cube.from_cube(
        leaf, (None, plan.batch_axes or None, plan.kv_axes, None, None))


def _jax_heads(cfg, t, i):
    """The KV heads JAX's PE i of a tp group of t keeps (``_split_qkv``)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if KV >= t and KV % t == 0:
        return slice(i * (KV // t), (i + 1) * (KV // t))
    Hl, G = H // t, H // KV
    if Hl >= G:
        cnt = Hl // G
        return slice(i * cnt, (i + 1) * cnt)
    lo = (i * Hl) // G
    return slice(lo, lo + 1)


# ------------------------------------------------------------ vs the JAX prefill
@pytest.mark.parametrize("pes", [1, 2, 4])
@pytest.mark.parametrize("cell", ["qwen3", "qwen2_moe", "phi3", "gemma3",
                                  "internlm2"])
def test_prefill_matches_jax(f32_reference, cell, pes):
    jcfg, pcfg = _configs(cell, pes)
    B, S = 2, 16
    tokens = _tokens(jcfg, 6, (B, S))
    jtopo = jax_topology(jcfg, make_mesh((1, pes), ("data", "model")))
    jparams = jax_params.init_params(jcfg, jtopo, seed=3)
    srv = jax_serving.Server(jcfg, jtopo, None)
    axes = tuple(jtopo.cube.mesh.axis_names)

    def jfn(params, batch):
        logits, cache = srv.prefill_shard(params, batch)
        return logits, jax.tree.map(lambda t: t[None], cache)

    ref, jcache = jax.jit(shard_map(
        jfn, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  {"tokens": P(jtopo.dp, None)}),
        out_specs=(P(jtopo.dp, jtopo.tp), P(axes)), check_vma=False))(
        jparams, {"tokens": jnp.asarray(tokens)})

    topo = build_serve_topology(pcfg, pes)
    assert topo.cube == build_topology(pcfg, pes).cube
    plan = make_serve_plan(pcfg, topo, S_ctx=S + 4, global_batch=B)
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    logits, cache = server.prefill_shard(params, {
        "tokens": topo.cube.to_cube(torch.from_numpy(tokens).long(),
                                    (plan.batch_axes or None, None))})
    got = topo.cube.from_cube(logits, (plan.batch_axes or None, topo.tp))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= _bound(ref,
                                                                JAX_TOL)
    zeros = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
    S_pe = S // pes
    for key in ("k", "v"):
        leaf = cache["p0"][key]
        assert leaf.shape == zeros["p0"][key].shape
        assert leaf.dtype == zeros["p0"][key].dtype
        glob = _global_kv(topo, plan, leaf).numpy()
        assert not glob[:, :, S:].any()         # slots past the prompt
        want = np.asarray(jcache["p0"][key])     # (pes, n_units, B, S_pe, ..)
        for i in range(pes):
            mine = glob[:, :, i * S_pe:(i + 1) * S_pe,
                        _jax_heads(pcfg, pes, i)]
            assert mine.shape == want[i].shape
            assert np.abs(mine - want[i]).max() <= _bound(want[i], JAX_TOL)


# --------------------------------------------------- vs the teacher-forced loop
def _step(server, params, cache, toks, t):
    """One decode step of every request at position t; global logits."""
    topo, plan = server.topo, server.plan
    ba = plan.batch_axes or None
    pos = torch.full(toks.shape, t)
    logits, _ = server.decode_shard(params, cache,
                                    topo.cube.to_cube(toks, (ba,)),
                                    topo.cube.to_cube(pos, (ba,)))
    return topo.cube.from_cube(logits, (ba, topo.tp))


def _close(got, want, tol=LOOP_TOL):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * max(
        1.0, float(want.abs().max()))


def _prefill_vs_loop(cell, pes, prompt_len, gen=5, B=2):
    _, pcfg = _configs(cell, pes)
    topo = build_serve_topology(pcfg, pes)
    plan = make_serve_plan(pcfg, topo, S_ctx=prompt_len + gen,
                           global_batch=B)
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = init_params(pcfg, topo, 11, device=CPU)
    toks = torch.from_numpy(_tokens(pcfg, 12, (B, prompt_len))).long()
    loop = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
    refs, nxt = [], None
    for t in range(prompt_len + gen - 1):
        lg = _step(server, params, loop,
                   toks[:, t] if t < prompt_len else nxt, t)
        if t == prompt_len - 1:
            after_prompt = {p: {k: v.clone() for k, v in c.items()}
                            for p, c in loop.items()}
        if t >= prompt_len - 1:
            nxt = lg.argmax(-1)
            refs.append(lg)

    logits, cache = server.prefill_shard(params, {
        "tokens": topo.cube.to_cube(toks, (plan.batch_axes or None, None))})
    for p, c in after_prompt.items():
        for k, want in c.items():
            assert cache[p][k].dtype == want.dtype
            _close(cache[p][k], want)
    last = topo.cube.from_cube(logits, (plan.batch_axes or None, topo.tp))
    _close(last, refs[0])
    out = [last.argmax(-1)]
    for i, t in enumerate(range(prompt_len, prompt_len + gen - 1)):
        lg = _step(server, params, cache, out[-1], t)
        _close(lg, refs[i + 1])
        out.append(lg.argmax(-1))
    np.testing.assert_array_equal(
        torch.stack(out, 1).numpy(),
        torch.stack([r.argmax(-1) for r in refs], 1).numpy())
    return plan


@pytest.mark.parametrize("cell,pes", [
    (c, p) for c in ("qwen3", "qwen2_moe", "phi3", "gemma3")
    for p in (1, 2, 4, 8)] + [("internlm2", p) for p in (1, 2, 4)])
def test_prefill_then_decode_equals_teacher_forced_loop(cell, pes):
    plan = _prefill_vs_loop(cell, pes, prompt_len=12 if cell == "gemma3"
                            else 8)
    assert plan.S_cache >= plan.S_ctx          # not rolling


@pytest.mark.parametrize("pes", [1, 2, 4])
def test_prefill_fills_the_rolling_cache(pes):
    """mixtral's smoke window of 8 bounds its cache at 8 slots (rounded up
    to the PEs), and the 12-token prompt runs past it: prefill keeps the
    last S_cache keys, each at slot position % S_cache."""
    plan = _prefill_vs_loop("mixtral", pes, prompt_len=12)
    assert plan.S_cache < 12 < plan.S_ctx


@pytest.mark.parametrize("cell,pes,prompt_len", [
    ("qwen3", 4, 7), ("qwen3", 8, 13), ("gemma3", 4, 10),
    ("qwen2_moe", 4, 6)])
def test_prefill_of_a_prompt_that_does_not_split(cell, pes, prompt_len):
    """A prompt length that is no multiple of tp: the forward pads its end,
    the cache and the last logits leave the pad out."""
    assert prompt_len % pes
    _prefill_vs_loop(cell, pes, prompt_len)


def test_prefill_reshard_is_one_all_to_all_per_layer():
    """Sharded KV heads (qwen3 at tp 2): one all_to_all of K and V stacked
    per attention layer, over tp; replicated heads (gemma3's 1 at tp 4):
    none."""
    from repro_torch.core.comm import CommTrace
    for cell, pes, want in (("qwen3", 2, 2), ("gemma3", 4, 0)):
        _, pcfg = _configs(cell, pes)
        topo = build_serve_topology(pcfg, pes)
        plan = make_serve_plan(pcfg, topo, S_ctx=16, global_batch=1)
        params = init_params(pcfg, topo, 1, device=CPU)
        toks = topo.cube.to_cube(torch.zeros(1, 8, dtype=torch.long),
                                 (None, None))
        with CommTrace() as tr:
            Server(pcfg, topo, plan, dtype=torch.float32).prefill_shard(
                params, {"tokens": toks})
        a2a = [e for e in tr.events if e.primitive == "all_to_all"]
        assert len(a2a) == want == (pcfg.n_layers if want else 0)
        assert all(e.dims == topo.tp for e in a2a)


def test_prompt_longer_than_a_full_cache_raises():
    _, pcfg = _configs("qwen3", 1)
    topo = build_serve_topology(pcfg, 1)
    plan = make_serve_plan(pcfg, topo, S_ctx=6, global_batch=1)
    with pytest.raises(ValueError, match="does not fit the decode cache"):
        Server(pcfg, topo, plan).prefill_shard(
            {}, {"tokens": torch.zeros((1, 1, 1, 8), dtype=torch.int64)})


def test_rwkv_prompt_must_split():
    pcfg = dataclasses.replace(configs.get("rwkv6-7b").scaled_for_smoke(),
                               tp=2)
    topo = build_serve_topology(pcfg, 2)
    plan = make_serve_plan(pcfg, topo, S_ctx=12, global_batch=1)
    with pytest.raises(ValueError, match="RWKV6 recurrence"):
        Server(pcfg, topo, plan).prefill_shard(
            {}, {"tokens": torch.zeros((1, 2, 1, 7), dtype=torch.int64)})


# ---------------------------------------------------------------- sort dispatch
def _moe_configs(pes, dispatch):
    jcfg, pcfg = _configs("qwen2_moe", pes)
    return (dataclasses.replace(jcfg, moe_dispatch=dispatch,
                                capacity_factor=1.25),
            dataclasses.replace(pcfg, moe_dispatch=dispatch,
                                capacity_factor=1.25))


def _moe_weights(cfg, seed):
    """Global MoE leaves at unit scale (NumPy); a sharp router."""
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


def _repeated(rng, n, D, every=4):
    """(n, D) rows, all equal except every ``every``-th: the repeated row's
    experts overflow their capacity."""
    x = np.repeat(rng.standard_normal((1, D)), n, axis=0)
    x[::every] = rng.standard_normal((len(x[::every]), D))
    return x.astype(np.float32)


def _port_weights(pcfg, topo, w):
    defs = _moe_ffn_defs(pcfg, topo)
    specs = {k: d.spec for k, d in defs.items()}
    placed = {k: topo.cube.to_cube(torch.from_numpy(w[k]), specs[k])
              for k in defs}
    return blocks.gather_params(placed, specs, topo, torch.float32)


def _port_moe(monkeypatch, pcfg, topo, w, x):
    """The port's moe_ffn on global x (B, S, D); returns (out, aux per PE,
    the top-k ids per PE of its one routing)."""
    calls = []
    route = blocks._route

    def recording(cfg, hn2d, router, cn):
        topi, topv, probs = route(cfg, hn2d, router, cn)
        calls.append(topi.reshape((-1,) + tuple(topi.shape[cn:])).numpy())
        return topi, topv, probs

    monkeypatch.setattr(blocks, "_route", recording)
    spec = (topo.dp, topo.sp, None)
    out, aux = blocks.moe_ffn(pcfg, topo, _port_weights(pcfg, topo, w),
                              topo.cube.to_cube(torch.from_numpy(x), spec))
    monkeypatch.setattr(blocks, "_route", route)
    assert len(calls) == 1
    return topo.cube.from_cube(out, spec), aux.reshape(-1), calls[0]


@pytest.mark.parametrize("pes", [1, 2, 4, 8])
def test_sort_dispatch_matches_jax(f32_reference, monkeypatch, pes):
    """The sequence-parallel MoE block under "sort": outputs, the aux loss
    per PE and every PE's top-k expert ids against JAX's under "sort", on a
    batch that drops choices."""
    jcfg, pcfg = _moe_configs(pes, "sort")
    B, S = 2, 16
    rng = np.random.RandomState(20 + pes)
    w = _moe_weights(pcfg, 4)
    x = _repeated(rng, B * S, pcfg.d_model).reshape(B, S, -1)
    jtopo = jax_topology(jcfg, make_mesh((1, pes), ("data", "model")))
    jspecs = {k: d.spec for k, d in jax_params._moe_ffn_defs(
        jcfg, jtopo).items()}
    xspec = P(jtopo.dp, jtopo.sp, None)
    axes = tuple(jtopo.cube.mesh.axis_names)

    def jfn(w_, x_):
        wg = jax_blocks.gather_params(w_, jspecs, jtopo)
        topi = []
        route = jax_blocks._route

        def recording(cfg, hn2d, router):
            out = route(cfg, hn2d, router)
            topi.append(out[0])
            return out

        jax_blocks._route = recording
        try:
            y, aux = jax_blocks.moe_ffn(jcfg, jtopo, wg, x_)
        finally:
            jax_blocks._route = route
        return y, aux.reshape(1), topi[0][None]

    ref, ref_aux, ref_ids = jax.jit(shard_map(
        jfn, mesh=jtopo.cube.mesh, in_specs=(jspecs, xspec),
        out_specs=(xspec, P(axes), P(axes)), check_vma=False))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))

    topo = build_topology(pcfg, pes)
    out, aux, ids = _port_moe(monkeypatch, pcfg, topo, w, x)
    T = B * S // topo.size(topo.ep)             # tokens a PE routes
    C = math.ceil(T * pcfg.top_k / pcfg.n_experts_padded
                  * pcfg.capacity_factor)
    assert max(np.bincount(r.reshape(-1)).max() for r in ids) > C
    np.testing.assert_array_equal(ids.reshape(np.asarray(ref_ids).shape),
                                  np.asarray(ref_ids))
    ref = np.asarray(ref)
    assert np.abs(out.numpy() - ref).max() <= _bound(ref, JAX_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), rtol=1e-5)


@pytest.mark.parametrize("pes", [1, 2, 4, 8])
@pytest.mark.parametrize("every", [4, 64])
def test_sort_dispatch_equals_scatter_bit_for_bit(monkeypatch, pes, every):
    """Both dispatches rank a choice by token order within its expert, so
    they drop the same choices and give the same bits: on a batch that
    drops choices (every=4) and one that drops none (every=64 at a
    capacity that holds them all)."""
    outs = {}
    for dispatch in ("scatter", "sort"):
        _, pcfg = _moe_configs(pes, dispatch)
        if every == 64:
            pcfg = dataclasses.replace(pcfg, capacity_factor=NO_DROP)
        topo = build_topology(pcfg, pes)
        rng = np.random.RandomState(30 + pes)
        x = _repeated(rng, 2 * 16, pcfg.d_model, every).reshape(2, 16, -1)
        outs[dispatch] = _port_moe(monkeypatch, pcfg, topo,
                                   _moe_weights(pcfg, 5), x)
    for a, b in zip(outs["scatter"], outs["sort"]):
        a = torch.as_tensor(a)
        b = torch.as_tensor(b)
        assert torch.equal(a, b)


def test_sort_dispatch_buffer_and_ranks():
    """``_sort_dispatch`` on a hand-made routing: each expert's first C
    choices in token order fill its slots, the rest are ranked past C."""
    T, k, Ep, C, D = 5, 2, 4, 2, 3
    h2 = torch.arange(T * D, dtype=torch.float32).reshape(1, T, D)
    flat_e = torch.tensor([[2, 0, 2, 1, 2, 0, 3, 2, 0, 1]])
    disp, rank = blocks._sort_dispatch(h2, flat_e, Ep, C, k)
    np.testing.assert_array_equal(rank[0].numpy(),
                                  [0, 0, 1, 0, 2, 1, 0, 3, 2, 1])
    want = torch.zeros(Ep, C, D)
    want[0, 0], want[0, 1] = h2[0, 0], h2[0, 2]    # choices 1, 5
    want[1, 0], want[1, 1] = h2[0, 1], h2[0, 4]    # choices 3, 9
    want[2, 0], want[2, 1] = h2[0, 0], h2[0, 1]    # choices 0, 2
    want[3, 0] = h2[0, 3]                           # choice 6
    assert torch.equal(disp.reshape(Ep, C, D), want)


def test_sort_dispatch_forward_equals_scatter():
    """qwen2-moe's forward_logits under "sort" is the "scatter" forward,
    bit for bit (smoke size, 4 PEs: ep 4, the stock capacity factor)."""
    outs = []
    for dispatch in ("scatter", "sort"):
        _, pcfg = _configs("qwen2_moe", 4)
        pcfg = dataclasses.replace(pcfg, moe_dispatch=dispatch,
                                   capacity_factor=1.0)
        topo = build_topology(pcfg, 4)
        params = init_params(pcfg, topo, 2, device=CPU)
        toks = torch.from_numpy(_tokens(pcfg, 3, (2, 16))).long()
        outs.append(Model(pcfg, topo, dtype=torch.float32).forward_logits(
            params, {"tokens": topo.cube.to_cube(toks, (topo.dp, None))}))
    assert torch.equal(outs[0], outs[1])
