"""The port's llava-next-34b (the patch frontend: precomputed patch
embeddings projected into the first ``frontend_tokens`` positions) held
against the JAX package on the CPU, both packages in f32 (the JAX compute
dtype set with ``monkeypatch``), at the smoke size (2 layers of d_model
64, 4 heads of 16 over 2 KV heads, 8 patches of 32), on the JAX package's
weights carried across with ``from_jax_params`` and batches (tokens,
labels, patches) from the JAX ``TokenStream``. The G = 7 cases keep
llava's own group of 7 query heads a KV head (56 / 8) as 14 / 2.

- the parameter tree: paths, shapes, specs and flat order equal JAX's,
  with ``frontend_proj``;
- ``forward_logits`` at 1, 2 and 4 PEs within ``TOL`` x max(1,
  max|ref|) (greedy tokens identical), and at G = 7 at 1 and 2 PEs;
- ``loss_shard`` at 1 and 2 PEs within ``LOSS_TOL`` relative; the patch
  positions are masked by the model, whatever the labels hold there;
- the 1-PE gradients against ``jax.grad`` of ``loss_shard``
  (``pvary_identity``) within ``TOL`` x max(1, max|ref|) per leaf,
  ``frontend_proj`` included;
- ``prefill_shard`` with patches at 1 PE against JAX's (last logits, the
  K/V cache) within ``JAX_TOL``; decode from the port's prefill against
  ``forward_logits`` of the whole sequence, the port's and JAX's, at 1, 2
  and 4 PEs and at G = 7, within ``TOL``;
- ``ServeEngine``'s greedy tokens and schedule against the JAX engine's
  on one trace of text requests at tp 2, and the launchers on the CPU.
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
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    from_jax_params, leaves, param_defs, param_specs, to_global, trainable)
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology
from repro_torch.runtime import trainer as tr

ARCH = "llava-next-34b"
TOL = 1e-4          # f32 in both packages; x max(1, max|ref|)
JAX_TOL = 1e-5      # prefill against JAX's, x max(1, max|ref|)
LOSS_TOL = 1e-5     # relative
CPU = torch.device("cpu")
G7 = {"n_heads": 14, "n_kv_heads": 2}     # llava's G = 7 at smoke width


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


def _bound(ref, tol=TOL):
    return tol * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _cfgs(pes, **changes):
    def cut(cfg):
        return dataclasses.replace(cfg.scaled_for_smoke(), tp=pes, **changes)
    return cut(jax_get(ARCH)), cut(configs.get(ARCH))


def _jax(pes, seed=1, **changes):
    jcfg, pcfg = _cfgs(pes, **changes)
    jtopo = jax_topology(jcfg, make_mesh((1, pes), ("data", "model")))
    return jcfg, pcfg, jtopo, jax_params.init_params(jcfg, jtopo, seed=seed)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(jcfg, B=2, S=24, seed=0):
    """A JAX TokenStream batch: tokens, labels (-1 at the patches and at
    document breaks) and the patches stub."""
    return JaxTokenStream(jcfg, JaxDataConfig(
        seq_len=S, global_batch=B, vocab_size=jcfg.vocab_size, seed=seed,
        doc_len_mean=8)).global_batch_at(seed)


def _jax_fn(jtopo, jcfg, fn, out_spec):
    return jax.jit(shard_map(
        fn, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  jax_batch_specs(jcfg, jtopo)),
        out_specs=out_spec, check_vma=False))


def _norm(spec) -> tuple:
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
    fp = dict(pl)[("frontend_proj",)]
    assert fp.shape == (pcfg.frontend_dim, pcfg.d_model)


# ----------------------------------------------------------------- forward
def _jax_forward(jcfg, jtopo, jparams, b):
    fwd = _jax_fn(jtopo, jcfg, jax_lm.Model(jcfg, jtopo).forward_logits,
                  P(jtopo.dp, None, jtopo.tp))
    return np.asarray(fwd(jparams, {k: jnp.asarray(v) for k, v in
                                    b.items()}))


def _port_forward(pcfg, pes, jparams, b):
    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    with torch.no_grad():
        logits = Model(pcfg, topo, dtype=torch.float32).forward_logits(
            params, tr.place_batch(b, pcfg, topo, CPU))
    return topo.cube.from_cube(logits, (topo.dp, None, topo.tp)).numpy()


FORWARD_CASES = ([pytest.param(p, {}, id=f"{p}pe") for p in (1, 2, 4)]
                 + [pytest.param(p, G7, id=f"G7-{p}pe") for p in (1, 2)])


@pytest.mark.parametrize("pes,changes", FORWARD_CASES)
def test_forward_logits_matches_jax(f32_reference, pes, changes):
    jcfg, pcfg, jtopo, jparams = _jax(pes, **changes)
    b = _batch(jcfg)
    ref = _jax_forward(jcfg, jtopo, jparams, b)
    got = _port_forward(pcfg, pes, jparams, b)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= _bound(ref)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_patches_reach_the_logits(f32_reference):
    """Other patches change the logits at every position (the patches sit
    in front of the text), the same tokens and weights otherwise."""
    _, pcfg, _, jparams = _jax(2)
    b = _batch(_cfgs(2)[0])
    other = dict(b, patches=b["patches"][::-1].copy())
    a, c = (_port_forward(pcfg, 2, jparams, x) for x in (b, other))
    assert (np.abs(a - c).max(axis=-1) > 0).all()


# -------------------------------------------------------------- training
@pytest.mark.parametrize("pes", [1, 2])
def test_loss_shard_matches_jax_and_masks_patches(f32_reference, pes):
    """The loss against JAX's; labels at the patch positions set to real
    ids change neither package's loss nor the port's token count."""
    jcfg, pcfg, jtopo, jparams = _jax(pes)
    b = _batch(jcfg, S=32)
    F_ = pcfg.frontend_tokens
    assert (b["labels"][:, :F_] == -1).all()
    filled = dict(b, labels=b["labels"].copy())
    filled["labels"][:, :F_] = 7
    loss = _jax_fn(jtopo, jcfg,
                   lambda p, bb: jax_lm.Model(jcfg, jtopo).loss_shard(
                       p, bb)[0], P())
    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    model = Model(pcfg, topo, dtype=torch.float32)
    for batch in (b, filled):
        ref = float(loss(jparams, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))
        with torch.no_grad():
            got, metrics = model.loss_shard(
                params, tr.place_batch(batch, pcfg, topo, CPU))
        assert abs(float(got.reshape(-1)[0]) - ref) <= LOSS_TOL * abs(ref)
        assert float(metrics["tokens"].reshape(-1)[0]) == float(
            (b["labels"] >= 0).sum())


def test_single_pe_grads_match_jax_grad(f32_reference, pvary_identity):
    jcfg, pcfg, jtopo, jparams = _jax(1, seed=0)
    b = _batch(jcfg, S=32)
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
    _, _, grads = step.fwd_bwd(masters, tr.place_batch(b, pcfg, topo, CPU))
    grads = to_global(step.sync(grads, {}), param_specs(pcfg, topo),
                      topo.cube)
    got, want = list(leaves(grads)), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        assert np.abs(g.numpy() - w).max() <= TOL * max(1.0, np.abs(w).max()
                                                        ), path
    assert float(dict(got)[("frontend_proj",)].abs().max()) > 0


# ------------------------------------------------------------ prefill, decode
def _jax_prefill(jcfg, jtopo, jparams, tokens, patches):
    srv = jax_serving.Server(jcfg, jtopo, None)
    axes = tuple(jtopo.cube.mesh.axis_names)

    def fn(params, batch):
        logits, cache = srv.prefill_shard(params, batch)
        return logits, jax.tree.map(lambda t: t[None], cache)

    logits, cache = jax.jit(shard_map(
        fn, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  {"tokens": P(jtopo.dp, None),
                   "patches": P(jtopo.dp, None, None)}),
        out_specs=(P(jtopo.dp, jtopo.tp), P(axes)), check_vma=False))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "patches": jnp.asarray(patches)})
    return np.asarray(logits), jax.tree.map(lambda t: t[0], cache)


def _port_serve(pcfg, pes, jparams, S_ctx, B):
    topo = build_serve_topology(pcfg, pes)
    plan = make_serve_plan(pcfg, topo, S_ctx=S_ctx, global_batch=B)
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    return topo, plan, server, params


def _prefill(server, topo, plan, params, tokens, patches):
    ba = plan.batch_axes or None
    with torch.no_grad():
        return server.prefill_shard(params, {
            "tokens": topo.cube.to_cube(torch.from_numpy(tokens).long(),
                                        (ba, None)),
            "patches": topo.cube.to_cube(torch.from_numpy(patches),
                                         (ba, None, None))})


def test_prefill_with_patches_matches_jax(f32_reference):
    B, S_ctx, prompt = 2, 24, 16
    jcfg, pcfg, jtopo, jparams = _jax(1)
    b = _batch(jcfg, B=B, S=S_ctx)
    jlogits, jcache = _jax_prefill(jcfg, jtopo, jparams,
                                   b["tokens"][:, :prompt], b["patches"])
    topo, plan, server, params = _port_serve(pcfg, 1, jparams, S_ctx, B)
    logits, cache = _prefill(server, topo, plan, params,
                             b["tokens"][:, :prompt], b["patches"])
    got = topo.cube.from_cube(logits, (None, topo.tp)).numpy()
    assert np.abs(got - jlogits).max() <= _bound(jlogits, JAX_TOL)
    zeros = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
    for key in ("k", "v"):
        leaf = cache["p0"][key]
        assert leaf.shape == zeros["p0"][key].shape
        glob = leaf.reshape(leaf.shape[topo.cube.ndim:]).numpy()
        want = np.asarray(jcache["p0"][key])
        assert np.abs(glob[:, :, :prompt] - want).max() <= _bound(want,
                                                                 JAX_TOL)
        assert not glob[:, :, prompt:].any()


DECODE_CASES = ([pytest.param(p, {}, id=f"{p}pe") for p in (1, 2, 4)]
                + [pytest.param(2, G7, id="G7-2pe")])


@pytest.mark.parametrize("pes,changes", DECODE_CASES)
def test_decode_from_prefill_matches_forward(f32_reference, pes, changes):
    """Prefill of 8 patches and 8 text tokens, then the rest teacher-forced
    through ``decode_shard``: each step's logits against
    ``forward_logits`` of the whole sequence (patches and tokens) at that
    position, the port's and JAX's."""
    B, S_ctx, prompt = 2, 24, 16
    jcfg, pcfg, jtopo, jparams = _jax(pes, **changes)
    b = _batch(jcfg, B=B, S=S_ctx)
    jref = _jax_forward(jcfg, jtopo, jparams, b)
    fwd = _port_forward(pcfg, pes, jparams, b)
    topo, plan, server, params = _port_serve(pcfg, pes, jparams, S_ctx, B)
    _, cache = _prefill(server, topo, plan, params, b["tokens"][:, :prompt],
                        b["patches"])
    cube, ba = topo.cube, plan.batch_axes or None
    for t in range(prompt, S_ctx):
        with torch.no_grad():
            logits, cache = server.decode_shard(
                params, cache,
                cube.to_cube(torch.from_numpy(b["tokens"][:, t]).long(),
                             (ba,)),
                cube.to_cube(torch.full((B,), t), (ba,)))
        got = cube.from_cube(logits, (ba, topo.tp)).numpy()
        assert np.abs(got - fwd[:, t]).max() <= _bound(fwd)
        assert np.abs(got - jref[:, t]).max() <= _bound(jref)


def test_prompt_shorter_than_the_patches_raises():
    _, pcfg = _cfgs(1)
    topo = build_topology(pcfg, 1)
    from repro_torch.models.params import init_params
    params = init_params(pcfg, topo, 0, device=CPU)
    b = _batch(_cfgs(1)[0], S=pcfg.frontend_tokens)
    b["tokens"] = b["tokens"][:, :4]
    with pytest.raises(ValueError, match="8 patches"):
        Model(pcfg, topo, dtype=torch.float32).embed_input(
            params, {"tokens": topo.cube.to_cube(
                torch.from_numpy(b["tokens"]).long(), (None, None)),
                "patches": topo.cube.to_cube(
                    torch.from_numpy(b["patches"]), (None, None, None))})


def test_engine_tokens_match_jax_engine(f32_reference):
    """The JAX ``ServeEngine`` serves llava's text (its requests carry no
    patches), and so does the port's, at tp 2: the same Poisson trace
    through both, f32, weights carried across, gives identical greedy
    tokens and the same schedule."""
    from repro.models.topology import build_serve_topology as \
        jax_serve_topology
    from repro.serving import ServeEngine as JaxServeEngine
    from repro_torch.serving import ServeEngine, poisson_trace
    jcfg, pcfg, jtopo, _ = _jax(2)
    jtopo = jax_serve_topology(jcfg, make_mesh((1, 2), ("data", "model")))
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=24,
                                        global_batch=2)
    jparams = jax_params.init_params(jcfg, jtopo, seed=2)

    def trace(cfg):
        return poisson_trace(4, rate=1.0, plen_range=(3, 6),
                             max_new_range=(3, 5), vocab=cfg.vocab_size,
                             seed=4)

    ref = JaxServeEngine(jcfg, jtopo, jplan, jparams).run(trace(jcfg))
    topo = build_serve_topology(pcfg, 2)
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


def test_launchers_run_llava_on_the_cpu(capsys):
    """The serve launcher's prompt is the patches (drawn from the seed)
    and ``--prompt-len`` text tokens, through ``prefill_shard``; the train
    launcher's batches carry ``TokenStream``'s patches."""
    run = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--pes", "2", "--batch", "2", "--prompt-len",
                               "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "prefill" in out
    assert run["prefill"] and run["tokens"].shape == (2, 8 + 4 + 3)
    assert run["patches"].shape == (2, 8, 32)
    tr_run = train_launcher.main(["--arch", ARCH, "--smoke", "--device",
                                  "cpu", "--pes", "2", "--steps", "2",
                                  "--batch", "2", "--seq", "24"])
    assert "final loss" in capsys.readouterr().out
    assert all(np.isfinite(h["loss"]) for h in tr_run["history"])
