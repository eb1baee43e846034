"""The port's jamba-1.5-large (the hybrid family: Mamba mixers 7:1 with
attention, MoE on every second layer) held against the JAX package on the
CPU, both packages in f32 (the JAX compute dtype set with
``monkeypatch``), at the smoke width (d_model 64, 4 heads of 16 over 2 KV
heads, 4 experts top-2, d_state 16, expand 2, conv 4) and one unit of
``mmmmAmmm`` (8 layers: every layer kind of the full model; the smoke
config's two units only double the time), on the JAX package's weights
carried across with ``from_jax_params`` and batches from the JAX
``TokenStream``.

- ``mamba_scan_chunked``, ``mamba_step`` and ``causal_conv1d`` (with and
  without the carry) against JAX's (``SSM_TOL``) and the scan against a
  sequential f64 recurrence written here (``SSM_TOL``), at moderate decay
  and at strong decay (exp(dt A) down to about e^-100, in f32's subnormal
  range); the port's in-chunk scan multiplies decays in (0, 1] only, so it
  cannot overflow the way a log-space cumulative sum's exp(-L) does; the
  scan in groups of chunks and its gradient through their checkpoints;
- the parameter tree: paths, shapes, specs, inits and flat order equal
  JAX's;
- ``forward_logits`` at 1 PE, ep 2, data 2 and ep 2 x etp 2 within
  ``TOL`` x max(1, max|ref|) (greedy tokens identical), ``loss_shard`` at
  1 PE, ep 2 and ep 2 x etp 2 within ``LOSS_TOL`` relative, the 1-PE
  gradients against ``jax.grad`` of ``loss_shard`` (``pvary_identity``)
  within ``TOL`` x max(1, max|ref|) per leaf;
- prefill, decode, the engine and the launchers are in
  ``tests/test_torch_jamba_serving.py``.
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
import repro.models.ssm as jax_ssm
from repro.compat import shard_map
from repro.configs import get as jax_get
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenStream as JaxTokenStream
from repro.launch.mesh import make_mesh
from repro.models.topology import build_topology as jax_topology
from repro.runtime.trainer import input_batch_specs as jax_batch_specs

from repro_torch import configs
from repro_torch.models import ssm
from repro_torch.models.config import MAMBA, MOE
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    from_jax_params, leaves, param_defs, param_specs, to_global, trainable)
from repro_torch.models.topology import build_topology
from repro_torch.runtime import trainer as tr

ARCH = "jamba-1.5-large"
TOL = 1e-4          # f32 in both packages; x max(1, max|ref|)
LOSS_TOL = 1e-5     # relative
SSM_TOL = 1e-5      # the Mamba functions, x max(1, max|ref|)
CPU = torch.device("cpu")
# (data, ep, etp) layouts: 1 PE, ep 2, data 2 and ep 2 x etp 2
LAYOUTS = [(1, 1, 1), (1, 2, 1), (2, 1, 1), (1, 2, 2)]


def _lid(lay):
    return "x".join(map(str, lay))


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


# ------------------------------------------------------------------ the SSM
def _ssm_inputs(seed, B, S, Din, N, strong):
    """Scan inputs: dt from a softplus as in the model (moderate), or
    dt in [0.5, 2] against A = -(1 .. N) x 16 (strong: exp(dt A) down to
    about e^-100 at the last state channel at dt 2 ... e^-2048: zero)."""
    rng = np.random.RandomState(seed)
    u = rng.randn(B, S, Din).astype(np.float32)
    if strong:
        dt = rng.uniform(0.5, 2.0, (B, S, Din)).astype(np.float32)
        A = -16.0 * np.tile(np.arange(1, N + 1, dtype=np.float32), (Din, 1))
    else:
        dt = np.log1p(np.exp(rng.randn(B, S, Din) - 3.0)).astype(np.float32)
        A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (Din, 1))
    Bm = rng.randn(B, S, N).astype(np.float32)
    Cm = rng.randn(B, S, N).astype(np.float32)
    h0 = rng.randn(B, Din, N).astype(np.float32)
    return u, dt, A, Bm, Cm, h0


def _sequential_f64(u, dt, A, Bm, Cm, h):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t, y_t = C_t . h_t in f64."""
    u, dt, A, Bm, Cm, h = (np.asarray(a, np.float64)
                           for a in (u, dt, A, Bm, Cm, h))
    ys = []
    for t in range(u.shape[1]):
        h = (np.exp(dt[:, t, :, None] * A) * h
             + dt[:, t, :, None] * Bm[:, t, None, :] * u[:, t, :, None])
        ys.append(np.einsum("bdn,bn->bd", h, Cm[:, t]))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("strong", [False, True], ids=["moderate", "strong"])
@pytest.mark.parametrize("S,state", [(48, False), (64, True), (96, True),
                                     (1, True)])
def test_mamba_scan_matches_jax_and_recurrence(S, state, strong):
    u, dt, A, Bm, Cm, h0 = _ssm_inputs(S, 2, S, 24, 16, strong)
    h0 = h0 if state else np.zeros_like(h0)
    y, h = ssm.mamba_scan_chunked(*(torch.from_numpy(a) for a in
                                    (u, dt, A, Bm, Cm, h0)))
    jy, jh = jax_ssm.mamba_scan_chunked(*(jnp.asarray(a) for a in
                                          (u, dt, A, Bm, Cm, h0)))
    ry, rh = _sequential_f64(u, dt, A, Bm, Cm, h0)
    for got, jax_ref, seq_ref in ((y, jy, ry), (h, jh, rh)):
        got = got.numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - np.asarray(jax_ref)).max() <= _bound(
            jax_ref, SSM_TOL)
        assert np.abs(got - seq_ref).max() <= _bound(seq_ref, SSM_TOL)
    # the port's own decode recurrence gives the same
    sy, sh = ssm.mamba_reference(*(torch.from_numpy(a) for a in
                                   (u, dt, A, Bm, Cm, h0)))
    assert np.abs(sy.numpy() - ry).max() <= _bound(ry, SSM_TOL)
    assert np.abs(sh.numpy() - rh).max() <= _bound(rh, SSM_TOL)


@pytest.mark.parametrize("chunks_a_group", [1, 2])
def test_mamba_scan_groups_of_chunks(monkeypatch, chunks_a_group):
    """The chunks go through the scan in groups bounded by
    ``ssm.GROUP_BYTES``: one chunk a group (the reference's own order) and
    two (three chunks: groups of 2 and 1) give the bits of one group of
    all chunks, forward and backward, but A's gradient: A is shared by
    every group, so its gradient sums the groups' in another order
    (within 1e-6 x max|dA|)."""
    arrs = _ssm_inputs(5, 2, 96, 8, 4, False)

    def run():
        a = [torch.from_numpy(x).requires_grad_() for x in arrs]
        y, h = ssm.mamba_scan_chunked(*a)
        (y.square().sum() + h.sum()).backward()
        return [y.detach(), h.detach()] + [x.grad for x in a]

    whole = run()
    per_chunk = 4 * 2 * 32 * 8 * 4          # one chunk's f32 term, bytes
    monkeypatch.setattr(ssm, "GROUP_BYTES", chunks_a_group * per_chunk)
    got = run()
    for i, (g, w) in enumerate(zip(got, whole)):
        if i == 4:      # dA
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
        else:
            assert torch.equal(g, w), i


def test_mamba_scan_refuses_lengths_off_its_chunks():
    """The reference's chunking: 100 steps do not split into chunks of
    min(32, S) re-fitted to divide S (3 chunks of 33)."""
    u, dt, A, Bm, Cm, _ = _ssm_inputs(0, 1, 100, 8, 4, False)
    with pytest.raises(ValueError, match="100 steps"):
        ssm.mamba_scan_chunked(*(torch.from_numpy(a) for a in
                                 (u, dt, A, Bm, Cm)))


def test_mamba_scan_grad_through_chunk_checkpoints():
    """Under autograd each chunk runs under a checkpoint; the gradients of
    every input (f32) equal autograd of the sequential recurrence within
    TOL x max(1, max|ref|)."""
    arrs = _ssm_inputs(3, 2, 64, 8, 4, False)
    a = [torch.from_numpy(x).requires_grad_() for x in arrs]
    b = [torch.from_numpy(x).requires_grad_() for x in arrs]
    y, h = ssm.mamba_scan_chunked(*a)
    (y.square().sum() + h.sum()).backward()
    ry, rh = ssm.mamba_reference(*b)
    (ry.square().sum() + rh.sum()).backward()
    for x, r in zip(a, b):
        assert float(r.grad.abs().max()) > 0
        assert float((x.grad - r.grad).abs().max()) <= _bound(r.grad)


@pytest.mark.parametrize("strong", [False, True], ids=["moderate", "strong"])
def test_mamba_step_matches_jax(strong):
    u, dt, A, Bm, Cm, h0 = _ssm_inputs(7, 3, 1, 24, 16, strong)
    args = (u[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0)
    y, h = ssm.mamba_step(*(torch.from_numpy(a) for a in args))
    jy, jh = jax_ssm.mamba_step(*(jnp.asarray(a) for a in args))
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= _bound(jy, SSM_TOL)
    assert np.abs(h.numpy() - np.asarray(jh)).max() <= _bound(jh, SSM_TOL)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("S", [1, 3, 17])
def test_causal_conv1d_matches_jax(S, carry):
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    c = rng.randn(2, 3, 12).astype(np.float32) if carry else None
    y, tail = ssm.causal_conv1d(*(None if a is None else torch.from_numpy(a)
                                  for a in (x, w, b, c)))
    jy, jtail = jax_ssm.causal_conv1d(*(None if a is None else jnp.asarray(a)
                                        for a in (x, w, b, c)))
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= _bound(jy, SSM_TOL)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


# -------------------------------------------------------------------- model
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


def _jax_fn(jtopo, jcfg, fn, out_spec):
    return jax.jit(shard_map(
        fn, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  jax_batch_specs(jcfg, jtopo)),
        out_specs=out_spec, check_vma=False))


def _norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def test_layer_plan():
    """One unit of 8: attention at index 4, Mamba elsewhere, MoE on every
    odd layer; the full config's 72 layers are 9 units."""
    cfg = configs.get(ARCH)
    assert cfg.unit() == 8 and cfg.n_layers // cfg.unit() == 9
    assert [m == MAMBA for m in cfg.mixers()[:8]] == [
        True, True, True, True, False, True, True, True]
    assert [f == MOE for f in cfg.ffns()[:8]] == [False, True] * 4


@pytest.mark.parametrize("layout", [(1, 1, 1), (1, 2, 2)], ids=_lid)
def test_param_tree_equals_jax(layout):
    jcfg, pcfg, jtopo, _ = _jax(layout)
    jdefs = jax_params.param_defs(jcfg, jtopo)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, jax_params.ParamDef))[0]
    pl = list(leaves(param_defs(pcfg, build_topology(pcfg,
                                                     np.prod(layout)))))
    assert len(pl) == len(jleaves)
    for (path, d), (jpath, jd) in zip(pl, jleaves):
        assert path == tuple(k.key for k in jpath)
        assert d.shape == jd.shape and d.init == jd.init, path
        assert _norm(d.spec) == _norm(jd.spec), path
        assert d.sum_axes == jd.sum_axes
    names = {p[-1] for p, _ in pl}
    assert {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
            "a_log", "d_skip", "out_proj", "router", "we_g"} <= names


def test_init_params_mamba_leaves():
    """a_log = log(1 .. N) on every channel, d_skip ones, conv_b zeros,
    dt_bias the inverse softplus of dt in [1e-3, 1e-1]."""
    from repro_torch.models.params import init_params
    _, pcfg = _cfgs()
    topo = build_topology(pcfg, 1)
    glob = to_global(init_params(pcfg, topo, 0, device=CPU),
                     param_specs(pcfg, topo), topo.cube)
    u = glob["units"]["p0"]
    n = pcfg.d_state
    want = np.log(np.arange(1, n + 1, dtype=np.float32))
    np.testing.assert_allclose(u["a_log"].numpy(), np.broadcast_to(
        want, u["a_log"].shape), rtol=1e-7)
    assert bool((u["d_skip"] == 1).all()) and not u["conv_b"].any()
    dt = torch.nn.functional.softplus(u["dt_bias"].double())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)


def _jax_forward(jcfg, jtopo, jparams, b):
    fwd = _jax_fn(jtopo, jcfg, jax_lm.Model(jcfg, jtopo).forward_logits,
                  P(jtopo.dp, None, jtopo.tp))
    return np.asarray(fwd(jparams, {k: jnp.asarray(v) for k, v in
                                    b.items()}))


def _port_forward(pcfg, topo, params, b):
    with torch.no_grad():
        logits = Model(pcfg, topo, dtype=torch.float32).forward_logits(
            params, tr.place_batch(b, pcfg, topo, CPU))
    return topo.cube.from_cube(logits, (topo.dp, None, topo.tp)).numpy()


@pytest.mark.parametrize("layout", LAYOUTS, ids=_lid)
def test_forward_logits_matches_jax(f32_reference, layout):
    jcfg, pcfg, jtopo, jparams = _jax(layout)
    b = _batch(jcfg, B=2 * layout[0])
    ref = _jax_forward(jcfg, jtopo, jparams, b)
    topo = build_topology(pcfg, int(np.prod(layout)))
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    got = _port_forward(pcfg, topo, params, b)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= _bound(ref)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("layout", [(1, 1, 1), (1, 2, 1), (1, 2, 2)],
                         ids=_lid)
def test_loss_shard_matches_jax(f32_reference, layout):
    jcfg, pcfg, jtopo, jparams = _jax(layout)
    b = _batch(jcfg, S=64)
    loss = _jax_fn(jtopo, jcfg,
                   lambda p, bb: jax_lm.Model(jcfg, jtopo).loss_shard(
                       p, bb)[0], P())
    ref = float(loss(jparams, {k: jnp.asarray(v) for k, v in b.items()}))
    topo = build_topology(pcfg, int(np.prod(layout)))
    params = from_jax_params(pcfg, topo, _np(jparams), device=CPU)
    with torch.no_grad():
        got, metrics = Model(pcfg, topo, dtype=torch.float32).loss_shard(
            params, tr.place_batch(b, pcfg, topo, CPU))
    assert abs(float(got.reshape(-1)[0]) - ref) <= LOSS_TOL * abs(ref)
    assert float(metrics["tokens"].reshape(-1)[0]) == float(
        (b["labels"] >= 0).sum())


def test_single_pe_grads_match_jax_grad(f32_reference, pvary_identity):
    jcfg, pcfg, jtopo, jparams = _jax((1, 1, 1), seed=0)
    b = _batch(jcfg, S=64)
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
    # the Mamba leaves receive gradients (a_log and dt through the scan)
    tree = dict(got)
    for name in ("in_proj", "conv_w", "x_proj", "dt_proj", "dt_bias",
                 "a_log", "d_skip", "out_proj"):
        assert float(tree[("units", "p0", name)].abs().max()) > 0, name
