"""The port's jamba-1.5-large served, held against the JAX package on the
CPU in f32 (the JAX compute dtype set with ``monkeypatch``), at the smoke
width and one unit of ``mmmmAmmm`` (as ``tests/test_torch_jamba.py``):

- ``prefill_shard`` at 1 PE against JAX's (last logits, every cache leaf:
  the SSM state, the conv tail, the attention K/V) within ``JAX_TOL``, and
  decode steps from it against JAX's decode from JAX's prefill; decode
  from the port's prefill against ``forward_logits`` at 1 PE and ep 2
  with the expert capacity at n_experts / top_k, where no choice is
  dropped in either path (MoE capacity makes decode and forward different
  functions elsewhere, in both packages);
- the pad refusal, ``ServeEngine``'s greedy tokens and schedule against
  the JAX engine's on one trace, the HF importer's refusal (JAX's refuses
  Mamba trees too) and the launchers on the CPU.
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
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenStream as JaxTokenStream
from repro.launch.mesh import make_mesh
from repro.models.topology import build_topology as jax_topology

from repro_torch import configs
from repro_torch.checkpoint import hf_import
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.lm import Model
from repro_torch.models.params import from_jax_params
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology
from repro_torch.runtime import trainer as tr

ARCH = "jamba-1.5-large"
TOL = 1e-4          # f32 in both packages; x max(1, max|ref|)
JAX_TOL = 1e-5      # prefill and decode against JAX's, x max(1, max|ref|)
CPU = torch.device("cpu")


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def _bound(ref, tol=TOL):
    return tol * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _cfgs(data=1, ep=1, etp=1, **changes):
    def cut(cfg):
        return dataclasses.replace(cfg.scaled_for_smoke(), ep=ep, etp=etp,
                                   **{"n_layers": 8, **changes})
    return cut(jax_get(ARCH)), cut(configs.get(ARCH))


def _jax(layout, seed=1, **changes):
    data, ep, etp = layout
    jcfg, pcfg = _cfgs(data, ep, etp, **changes)
    jtopo = jax_topology(jcfg, make_mesh((data, ep * etp), ("data",
                                                             "model")))
    return jcfg, pcfg, jtopo, jax_params.init_params(jcfg, jtopo, seed=seed)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(jcfg, B=2, S=32, seed=0):
    return JaxTokenStream(jcfg, JaxDataConfig(
        seq_len=S, global_batch=B, vocab_size=jcfg.vocab_size, seed=seed,
        doc_len_mean=8)).global_batch_at(seed)


def _port_forward(pcfg, topo, params, b):
    with torch.no_grad():
        logits = Model(pcfg, topo, dtype=torch.float32).forward_logits(
            params, tr.place_batch(b, pcfg, topo, CPU))
    return topo.cube.from_cube(logits, (topo.dp, None, topo.tp)).numpy()


# ------------------------------------------------------------ prefill, decode
def _jax_prefill(jcfg, jtopo, jparams, tokens):
    srv = jax_serving.Server(jcfg, jtopo, None)
    axes = tuple(jtopo.cube.mesh.axis_names)

    def fn(params, batch):
        logits, cache = srv.prefill_shard(params, batch)
        return logits, jax.tree.map(lambda t: t[None], cache)

    logits, cache = jax.jit(shard_map(
        fn, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  {"tokens": P(jtopo.dp, None)}),
        out_specs=(P(jtopo.dp, jtopo.tp), P(axes)), check_vma=False))(
        jparams, {"tokens": jnp.asarray(tokens)})
    return np.asarray(logits), jax.tree.map(lambda t: t[0], cache)


def _port_serve(pcfg, pes, jparams, S_ctx, B):
    topo = build_serve_topology(pcfg, pes)
    plan = make_serve_plan(pcfg, topo, S_ctx=S_ctx, global_batch=B)
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    return topo, plan, server, params


def _prefill(server, topo, plan, params, tokens):
    ba = plan.batch_axes or None
    with torch.no_grad():
        return server.prefill_shard(params, {"tokens": topo.cube.to_cube(
            torch.from_numpy(tokens).long(), (ba, None))})


def _decode(server, topo, plan, params, cache, tokens, t):
    ba = plan.batch_axes or None
    cube = topo.cube
    with torch.no_grad():
        logits, cache = server.decode_shard(
            params, cache, cube.to_cube(torch.from_numpy(tokens).long(),
                                        (ba,)),
            cube.to_cube(torch.full((len(tokens),), t), (ba,)))
    return cube.from_cube(logits, (ba, topo.tp)).numpy(), cache


def test_prefill_and_decode_match_jax(f32_reference):
    """At 1 PE (where JAX's prefill cache is the decode layout): the
    port's prefill of a 16-token prompt against JAX's (last logits and
    every cache leaf), then 8 decode steps from each package's own prefill,
    step by step."""
    B, S_ctx, prompt = 2, 24, 16
    jcfg, pcfg, jtopo, jparams = _jax((1, 1, 1))
    b = _batch(jcfg, B=B, S=S_ctx)
    jlogits, jcache = _jax_prefill(jcfg, jtopo, jparams,
                                   b["tokens"][:, :prompt])
    topo, plan, server, params = _port_serve(pcfg, 1, jparams, S_ctx, B)
    logits, cache = _prefill(server, topo, plan, params,
                             b["tokens"][:, :prompt])
    assert np.abs(logits.reshape(jlogits.shape).numpy()
                  - jlogits).max() <= _bound(jlogits, JAX_TOL)
    zeros = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
    for key, d in cache.items():
        assert set(d) == set(zeros[key]), key
        for name, leaf in d.items():
            assert leaf.shape == zeros[key][name].shape, (key, name)
            got = leaf.reshape(leaf.shape[topo.cube.ndim:]).numpy()
            want = np.asarray(jcache[key][name])
            if name in ("k", "v"):
                n = want.shape[2]
                assert n == prompt and not got[:, :, n:].any()
                got = got[:, :, :n]
            assert np.abs(got - want).max() <= _bound(want, JAX_TOL), name

    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S_ctx,
                                        global_batch=B)
    jc = jax_serving.init_cache(jcfg, jtopo, jplan)
    for key, d in jcache.items():
        for name, leaf in d.items():
            jc[key][name] = (jc[key][name].at[:, :, :prompt].set(leaf)
                             if name in ("k", "v") else leaf)
    cspecs = jax_serving.cache_specs(jcfg, jtopo, jplan)
    jstep = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, jplan).decode_shard,
        mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo), cspecs, P(None),
                  P(None)),
        out_specs=(P(None, jtopo.tp), cspecs), check_vma=False))
    for t in range(prompt, S_ctx):
        want, jc = jstep(jparams, jc, jnp.asarray(b["tokens"][:, t],
                                                  jnp.int32),
                         jnp.full((B,), t, jnp.int32))
        got, cache = _decode(server, topo, plan, params, cache,
                             b["tokens"][:, t], t)
        assert np.abs(got - np.asarray(want)).max() <= _bound(want, JAX_TOL)


@pytest.mark.parametrize("ep", [1, 2])
def test_decode_from_prefill_matches_forward(f32_reference, ep):
    """Prefill of a 16-token prompt, then the rest teacher-forced through
    ``decode_shard``: every step's logits against ``forward_logits`` of
    the whole sequence at that position, within TOL. The expert capacity
    is n_experts / top_k (= 2): every expert takes every token, so no
    choice is dropped in decode or forward."""
    B, S_ctx, prompt = 2, 32, 16
    jcfg, pcfg, _, jparams = _jax((1, ep, 1), capacity_factor=2.0)
    b = _batch(jcfg, B=B, S=S_ctx)
    ttopo = build_topology(pcfg, ep)
    fwd = _port_forward(pcfg, ttopo, from_jax_params(
        pcfg, ttopo, _np(jparams), device=CPU), b)
    topo, plan, server, params = _port_serve(pcfg, ep, jparams, S_ctx, B)
    _, cache = _prefill(server, topo, plan, params, b["tokens"][:, :prompt])
    worst = 0.0
    for t in range(prompt, S_ctx):
        got, cache = _decode(server, topo, plan, params, cache,
                             b["tokens"][:, t], t)
        worst = max(worst, float(np.abs(got - fwd[:, t]).max()))
    assert worst <= _bound(fwd)


def test_prefill_refuses_a_pad_into_the_state():
    """A prompt that does not split over the sequence-parallel PEs would
    pad, and the pad would run through the Mamba scan into its state."""
    _, pcfg = _cfgs(1, 2, 1)
    topo = build_serve_topology(pcfg, 2)
    plan = make_serve_plan(pcfg, topo, S_ctx=16, global_batch=1)
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    from repro_torch.models.params import init_params
    params = init_params(pcfg, topo, 0, device=CPU)
    with pytest.raises(ValueError, match="Mamba scan"):
        _prefill(server, topo, plan, params, np.zeros((1, 7), np.int64))


# ------------------------------------------------------- refusals, plumbing
def test_hf_import_refuses_mamba_trees():
    _, pcfg = _cfgs()
    with pytest.raises(hf_import.UnsupportedArchitecture, match="mamba"):
        hf_import.import_state_dict({}, pcfg)


def test_engine_tokens_match_jax_engine(f32_reference):
    """The JAX ``ServeEngine`` serves jamba (its Mamba rows stay per-slot
    rows beside the paged K/V, as the reference's do), and so does the
    port's: the same Poisson trace through both, f32, weights carried
    across, gives identical greedy tokens and the same schedule."""
    from repro.models.topology import build_serve_topology as \
        jax_serve_topology
    from repro.serving import ServeEngine as JaxServeEngine
    from repro_torch.serving import ServeEngine, poisson_trace
    jcfg, pcfg, jtopo, _ = _jax((1, 1, 1))
    jtopo = jax_serve_topology(jcfg, make_mesh((1, 1), ("data", "model")))
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=24,
                                        global_batch=2)
    jparams = jax_params.init_params(jcfg, jtopo, seed=2)

    def trace(cfg):
        return poisson_trace(4, rate=1.0, plen_range=(3, 6),
                             max_new_range=(3, 5), vocab=cfg.vocab_size,
                             seed=4)

    ref = JaxServeEngine(jcfg, jtopo, jplan, jparams).run(trace(jcfg))
    topo = build_serve_topology(pcfg, 1)
    plan = make_serve_plan(pcfg, topo, S_ctx=24, global_batch=2)
    eng = ServeEngine(pcfg, topo, plan, from_jax_params(
        pcfg, topo, _np(jparams), device=CPU), dtype=torch.float32,
        device="cpu")
    got = eng.run(trace(pcfg))
    assert got["steps"] == ref["steps"]
    for a, b in zip(sorted(got["finished"], key=lambda r: r.rid),
                    sorted(ref["finished"], key=lambda r: r.rid)):
        assert list(a.out_tokens) == list(b.out_tokens), a.rid
        assert (a.admitted_step, a.finished_step) == (
            b.admitted_step, b.finished_step), a.rid


def test_launchers_run_jamba_on_the_cpu(capsys):
    run = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--pes", "2", "--batch", "2", "--prompt-len",
                               "4", "--gen", "3"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out
    assert run["tokens"].shape == (2, 7)
    assert run["topo"].ep == ("ep",)
    assert run["flash_launches"] == 0 and run["reorder_launches"] == 0
    tr_run = train_launcher.main(["--arch", ARCH, "--smoke", "--device",
                                  "cpu", "--pes", "2", "--steps", "2",
                                  "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "final loss" in out
    assert all(np.isfinite(h["loss"]) for h in tr_run["history"])
