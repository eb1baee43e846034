"""The port's whisper-base (the encoder-decoder with the audio frontend)
held against the JAX package on the CPU, both packages in f32 (the JAX
compute dtype set with ``monkeypatch``), at the smoke size (4 heads of 16,
2 KV heads, 2 + 2 layers), on the JAX package's weights carried across
with ``from_jax_params`` and frames from the JAX ``TokenStream``.

- the parameter tree: paths, shapes, specs and flat order equal JAX's;
- ``Model.encode`` and ``forward_logits`` at 1, 2 and 4 PEs, within 1e-4
  x max(1, max|ref|) (greedy tokens identical);
- ``prefill_shard``'s cross K/V at 1 PE against JAX's (1e-5), and its
  last logits;
- decode from the port's prefill (self cache and cross cache) against
  ``forward_logits`` teacher-forced, the port's and JAX's, at 1, 2 and 4
  PEs: the bound is the one JAX's own decode meets against its forward
  on the same weights at 1 PE (measured here, from JAX's prefill, and
  printed under ``-s``) with a floor of 1e-5 x max(1, max|ref|). Seen:
  JAX's own 1.04e-7; the port against its forward 3.73e-8 / 7.45e-8 /
  5.96e-8 at 1 / 2 / 4 PEs and against JAX's 1.49e-7, max|logits| 0.603;
- ``loss_shard`` at 1 and 2 PEs and the 1-PE gradients against
  ``jax.grad`` of ``loss_shard`` (the ``pvary_identity`` fixture of
  ``tests/test_torch_train.py``);
- the engine's refusal, the HF importer's refusal, a checkpoint round
  trip, and the launchers on the CPU.
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
from repro.runtime.trainer import input_batch_specs as jax_batch_specs

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, TrainState, hf_import
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    flat_leaves, from_jax_params, init_params, leaves, param_defs,
    param_specs, to_global, trainable)
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology
from repro_torch.runtime import trainer as tr
from repro_torch.serving import ServeEngine

ARCH = "whisper-base"
TOL = 1e-4          # f32 in both packages; x max(1, max|ref|)
JAX_TOL = 1e-5      # prefill's cross K/V against JAX's
LOSS_TOL = 1e-5     # relative
CPU = torch.device("cpu")


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


@pytest.fixture
def pvary_identity(monkeypatch):
    """``jax.grad`` of ``loss_shard`` on a 1-PE mesh: ``compat.pvary`` is
    the identity there (see ``tests/test_torch_train.py``)."""
    import repro.compat as jax_compat
    monkeypatch.setattr(jax_compat, "pvary", lambda x, axes: x)


def _cfgs(pes):
    return (dataclasses.replace(jax_get(ARCH).scaled_for_smoke(), tp=pes),
            dataclasses.replace(configs.get(ARCH).scaled_for_smoke(),
                                tp=pes))


def _bound(ref, tol=TOL):
    return tol * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _batch(jcfg, B=2, S=16, seed=0):
    """A JAX TokenStream batch: tokens, labels and the frames stub."""
    return JaxTokenStream(jcfg, JaxDataConfig(
        seq_len=S, global_batch=B, vocab_size=jcfg.vocab_size, seed=seed,
        doc_len_mean=8)).global_batch_at(seed)


def _jax(pes, seed=1):
    jcfg, pcfg = _cfgs(pes)
    jtopo = jax_topology(jcfg, make_mesh((1, pes), ("data", "model")))
    return jcfg, pcfg, jtopo, jax_params.init_params(jcfg, jtopo, seed=seed)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_batch(batch, cfg, topo):
    return tr.place_batch(batch, cfg, topo, CPU)


def _jax_fn(jtopo, jcfg, fn, out_spec):
    return jax.jit(shard_map(
        fn, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  jax_batch_specs(jcfg, jtopo)),
        out_specs=out_spec, check_vma=False))


def _norm(spec) -> tuple:
    """A spec with one-name tuples as the name (JAX's PartitionSpec form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("pes", [1, 4])
def test_param_tree_equals_jax(pes):
    jcfg, pcfg, jtopo, _ = _jax(pes)
    jdefs = jax_params.param_defs(jcfg, jtopo)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, jax_params.ParamDef))[0]
    pl = list(leaves(param_defs(pcfg, build_topology(pcfg, pes))))
    assert len(pl) == len(jleaves)
    for (path, d), (jpath, jd) in zip(pl, jleaves):
        assert path == tuple(k.key for k in jpath)
        assert d.shape == jd.shape and d.init == jd.init
        assert _norm(d.spec) == _norm(jd.spec), path
        assert d.sum_axes == jd.sum_axes
    names = {p[-1] for p, _ in pl}
    assert {"xln", "xwq", "xwkv", "xwo", "frontend_proj",
            "enc_final_norm"} <= names
    assert not any(p[-1] in ("xq_norm", "xk_norm") for p, _ in pl)


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("pes", [1, 2, 4])
def test_encode_matches_jax(f32_reference, pes):
    jcfg, pcfg, jtopo, jparams = _jax(pes)
    b = _batch(jcfg)
    ref = np.asarray(jax.jit(shard_map(
        jax_lm.Model(jcfg, jtopo).encode, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo), P(jtopo.dp, None,
                                                         None)),
        out_specs=P(jtopo.dp, None, None), check_vma=False))(
        jparams, jnp.asarray(b["frames"])))
    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    got = Model(pcfg, topo, dtype=torch.float32).encode(
        params, _port_batch(b, pcfg, topo)["frames"])
    got = topo.cube.from_cube(got, (topo.dp, None, None)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= _bound(ref)


def _jax_forward(jcfg, jtopo, jparams, b):
    fwd = _jax_fn(jtopo, jcfg, jax_lm.Model(jcfg, jtopo).forward_logits,
                  P(jtopo.dp, None, jtopo.tp))
    return np.asarray(fwd(jparams, {k: jnp.asarray(v) for k, v in
                                    b.items()}))


@pytest.mark.parametrize("pes", [1, 2, 4])
def test_forward_logits_matches_jax(f32_reference, pes):
    jcfg, pcfg, jtopo, jparams = _jax(pes)
    b = _batch(jcfg)
    ref = _jax_forward(jcfg, jtopo, jparams, b)
    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    logits = Model(pcfg, topo, dtype=torch.float32).forward_logits(
        params, _port_batch(b, pcfg, topo))
    got = topo.cube.from_cube(logits, (topo.dp, None, topo.tp)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= _bound(ref)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# ------------------------------------------------------------ prefill, decode
def _jax_prefill(jcfg, jtopo, jparams, tokens, frames):
    srv = jax_serving.Server(jcfg, jtopo, None)
    axes = tuple(jtopo.cube.mesh.axis_names)

    def fn(params, batch):
        logits, cache = srv.prefill_shard(params, batch)
        return logits, jax.tree.map(lambda t: t[None], cache)

    return jax.jit(shard_map(
        fn, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  {"tokens": P(jtopo.dp, None),
                   "frames": P(jtopo.dp, None, None)}),
        out_specs=(P(jtopo.dp, jtopo.tp), P(axes)), check_vma=False))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "frames": jnp.asarray(frames)})


def _port_serve(pcfg, pes, jparams, S_ctx, B):
    topo = build_serve_topology(pcfg, pes)
    plan = make_serve_plan(pcfg, topo, S_ctx=S_ctx, global_batch=B)
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    return topo, plan, server, params


def _global_cache(topo, plan, leaf):
    return topo.cube.from_cube(
        leaf, (None, plan.batch_axes or None, plan.kv_axes, None, None))


def test_prefill_cross_kv_matches_jax(f32_reference):
    jcfg, pcfg, jtopo, jparams = _jax(1)
    B, S_ctx, prompt = 2, 16, 6
    b = _batch(jcfg, B=B, S=S_ctx)
    jlogits, jcache = _jax_prefill(jcfg, jtopo, jparams,
                                   b["tokens"][:, :prompt], b["frames"])
    topo, plan, server, params = _port_serve(pcfg, 1, jparams, S_ctx, B)
    ba = plan.batch_axes or None
    logits, cache = server.prefill_shard(params, {
        "tokens": topo.cube.to_cube(
            torch.from_numpy(b["tokens"][:, :prompt]).long(), (ba, None)),
        "frames": topo.cube.to_cube(torch.from_numpy(b["frames"]),
                                    (ba, None, None))})
    got = topo.cube.from_cube(logits, (ba, topo.tp)).numpy()
    assert np.abs(got - np.asarray(jlogits)).max() <= _bound(jlogits,
                                                             JAX_TOL)
    zeros = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
    for key in ("k", "v", "xk", "xv"):
        leaf = cache["p0"][key]
        assert leaf.shape == zeros["p0"][key].shape, key
        glob = _global_cache(topo, plan, leaf).numpy()
        want = np.asarray(jcache["p0"][key])[0]
        n = want.shape[2]          # the prompt's positions, or S_ctx
        assert n == (prompt if key in ("k", "v") else S_ctx)
        assert np.abs(glob[:, :, :n] - want).max() <= _bound(want, JAX_TOL)
        assert not glob[:, :, n:].any()


def _jax_decode_vs_forward(jcfg, jtopo, jparams, b, prompt):
    """JAX's own decode from its prefill against its forward at 1 PE
    (where JAX's prefill cache is the decode layout): the max difference
    over the decoded positions."""
    B, S_ctx = b["tokens"].shape
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S_ctx,
                                        global_batch=B)
    _, pre = _jax_prefill(jcfg, jtopo, jparams, b["tokens"][:, :prompt],
                          b["frames"])
    cache = jax_serving.init_cache(jcfg, jtopo, jplan)
    for key in ("k", "v"):
        cache["p0"][key] = cache["p0"][key].at[:, :, :prompt].set(
            pre["p0"][key][0])
    for key in ("xk", "xv"):
        cache["p0"][key] = pre["p0"][key][0]
    cspecs = jax_serving.cache_specs(jcfg, jtopo, jplan)
    step = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, jplan).decode_shard,
        mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo), cspecs, P(None),
                  P(None)),
        out_specs=(P(None, jtopo.tp), cspecs), check_vma=False))
    ref = _jax_forward(jcfg, jtopo, jparams, b)
    worst = 0.0
    for t in range(prompt, S_ctx):
        logits, cache = step(jparams, cache,
                             jnp.asarray(b["tokens"][:, t], jnp.int32),
                             jnp.full((B,), t, jnp.int32))
        worst = max(worst, float(np.abs(np.asarray(logits)
                                        - ref[:, t]).max()))
    return worst, ref


@pytest.mark.parametrize("pes", [1, 2, 4])
def test_decode_from_prefill_matches_forward(f32_reference, pes, capsys):
    """Prefill of a 6-token prompt with all S_ctx = 16 frames, then the
    remaining tokens teacher-forced through ``decode_shard``: each step's
    logits against ``forward_logits`` at that position, the port's and
    JAX's."""
    B, S_ctx, prompt = 2, 16, 6
    jcfg1, _, jtopo1, jparams = _jax(1)
    b = _batch(jcfg1, B=B, S=S_ctx)
    jax_err, jref = _jax_decode_vs_forward(jcfg1, jtopo1, jparams, b, prompt)
    bound = max(jax_err, _bound(jref, 1e-5))

    _, pcfg = _cfgs(pes)
    ttopo = build_topology(pcfg, pes)
    tparams = from_jax_params(pcfg, ttopo, _np(jparams), device=CPU)
    fwd = Model(pcfg, ttopo, dtype=torch.float32).forward_logits(
        tparams, _port_batch(b, pcfg, ttopo))
    fwd = ttopo.cube.from_cube(fwd, (ttopo.dp, None, ttopo.tp)).numpy()
    topo, plan, server, params = _port_serve(pcfg, pes, jparams, S_ctx, B)
    cube, ba = topo.cube, plan.batch_axes or None
    _, cache = server.prefill_shard(params, {
        "tokens": cube.to_cube(
            torch.from_numpy(b["tokens"][:, :prompt]).long(), (ba, None)),
        "frames": cube.to_cube(torch.from_numpy(b["frames"]),
                               (ba, None, None))})
    worst = vs_jax = 0.0
    for t in range(prompt, S_ctx):
        logits, cache = server.decode_shard(
            params, cache,
            cube.to_cube(torch.from_numpy(b["tokens"][:, t]).long(), (ba,)),
            cube.to_cube(torch.full((B,), t), (ba,)))
        got = cube.from_cube(logits, (ba, topo.tp)).numpy()
        worst = max(worst, float(np.abs(got - fwd[:, t]).max()))
        vs_jax = max(vs_jax, float(np.abs(got - jref[:, t]).max()))
    with capsys.disabled():
        print(f"\nwhisper decode vs forward at {pes} PEs: port {worst:.3g} "
              f"(vs JAX's forward {vs_jax:.3g}); JAX's own at 1 PE "
              f"{jax_err:.3g}; max |logits| {np.abs(jref).max():.3g}")
    assert worst <= bound and vs_jax <= bound


def test_cross_cache_must_split_and_fill():
    _, pcfg = _cfgs(4)
    topo = build_serve_topology(pcfg, 4)
    with pytest.raises(ValueError, match="14.*4"):
        init_cache(pcfg, topo, make_serve_plan(pcfg, topo, S_ctx=14,
                                               global_batch=1), device=CPU)
    plan = make_serve_plan(pcfg, topo, S_ctx=16, global_batch=1)
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = init_params(pcfg, topo, 0, device=CPU)
    with pytest.raises(ValueError, match="12.*16"):
        server.prefill_shard(params, {
            "tokens": topo.cube.to_cube(torch.zeros((1, 4), dtype=torch.long),
                                        (None, None)),
            "frames": topo.cube.to_cube(torch.zeros((1, 12,
                                                     pcfg.frontend_dim)),
                                        (None, None, None))})


# -------------------------------------------------------------- training
@pytest.mark.parametrize("pes", [1, 2])
def test_loss_shard_matches_jax(f32_reference, pes):
    jcfg, pcfg, jtopo, jparams = _jax(pes)
    b = _batch(jcfg, S=24)
    loss = _jax_fn(jtopo, jcfg,
                   lambda p, bb: jax_lm.Model(jcfg, jtopo).loss_shard(
                       p, bb)[0], P())
    ref = float(loss(jparams, {k: jnp.asarray(v) for k, v in b.items()}))
    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    got, _ = Model(pcfg, topo, dtype=torch.float32).loss_shard(
        params, _port_batch(b, pcfg, topo))
    assert abs(float(got.reshape(-1)[0]) - ref) <= LOSS_TOL * abs(ref)


def test_single_pe_grads_match_jax_grad(f32_reference, pvary_identity):
    jcfg, pcfg, jtopo, jparams = _jax(1, seed=0)
    b = _batch(jcfg, S=24)
    specs = jax_params.param_specs(jcfg, jtopo)
    model = jax_lm.Model(jcfg, jtopo)
    ref = jax.jit(shard_map(
        lambda p, bb: jax.grad(lambda q: model.loss_shard(q, bb)[0])(p),
        mesh=jtopo.cube.mesh, in_specs=(specs, jax_batch_specs(jcfg, jtopo)),
        out_specs=specs, check_vma=False))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    topo = build_topology(pcfg, 1)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    masters = trainable(params, param_specs(pcfg, topo), topo.cube)
    step = tr.make_train_step(pcfg, topo, tr.TrainConfig(),
                              dtype=torch.float32)
    _, _, grads = step.fwd_bwd(masters, _port_batch(b, pcfg, topo))
    grads = to_global(step.sync(grads, {}), param_specs(pcfg, topo),
                      topo.cube)
    got, want = flat_leaves(grads), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= TOL * max(1.0, np.abs(w).max())
    # the encoder and the cross-attention receive gradients
    tree = dict(leaves(grads))
    for path in (("frontend_proj",), ("enc_units", "p0", "wq"),
                 ("units", "p0", "xwkv"), ("enc_final_norm",)):
        assert float(tree[path].abs().max()) > 0, path


# ------------------------------------------------------- refusals, plumbing
def test_engine_and_hf_import_refuse_encoder_decoder():
    _, pcfg = _cfgs(1)
    topo = build_serve_topology(pcfg, 1)
    plan = make_serve_plan(pcfg, topo, S_ctx=8, global_batch=1)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServeEngine(pcfg, topo, plan, None, device="cpu")
    with pytest.raises(hf_import.UnsupportedArchitecture,
                       match="encoder-decoder"):
        hf_import.import_state_dict({}, pcfg)


def test_checkpoint_round_trip(tmp_path):
    """The whisper tree saved on a 2-PE training cube and restored onto
    the 4-PE serve cube, bit for bit against direct init there."""
    _, pcfg = _cfgs(2)
    train_topo = build_topology(pcfg, 2)
    params = init_params(pcfg, train_topo, 3, device=CPU)
    mgr = CheckpointManager(str(tmp_path), device="cpu", async_save=False,
                            topo=train_topo,
                            specs={"params": param_specs(pcfg, train_topo),
                                   "opt": None})
    mgr.save(1, TrainState(params=params))
    scfg = dataclasses.replace(pcfg, tp=4)
    stopo = build_serve_topology(scfg, 4)
    restored = mgr.restore_params(1, serve_topo=stopo,
                                  specs=param_specs(scfg, stopo))
    direct = init_params(scfg, stopo, 3, device=CPU)
    for (p, a), (_, b) in zip(leaves(restored), leaves(direct)):
        assert a.shape == b.shape and torch.equal(a, b), p


def test_launchers_run_whisper_on_the_cpu(capsys):
    run = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--batch", "2", "--prompt-len", "6", "--gen",
                               "2", "--pes", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "flash kernel launches=0" in out
    assert run["tokens"].shape == (2, 8) and run["prefill"]
    one = serve_launcher.serve(ARCH, batch=2, prompt_len=6, gen=2,
                               smoke=True, pes=1, device="cpu")
    np.testing.assert_array_equal(run["tokens"], one["tokens"])
    train_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--pes", "2", "--steps", "2"])
    assert "final loss" in capsys.readouterr().out
