"""The port's AdamW (``repro_torch.optim.adamw``) held against the JAX
package's on the same NumPy inputs: ``init_state``, ``update`` with 8-bit
and fp32 moments over several steps, and ``cosine_schedule``. The int8
moments are equal exactly, the scales within 1e-7 (relative), the params
and fp32 moments within 1e-6 (relative to max(1, max|ref|)); the port
writes them in place. The port's leaves are per PE (``cube_ndim`` leading
cube axes): a leaf sharded over two PEs is held to the JAX update of each
shard."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw

from repro_torch.optim import adamw

SCALE_TOL = 1e-7
PARAM_TOL = 1e-6


def _tree(seed, lead=()):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(*lead, 6, 40) * 0.1).astype(np.float32),
            "units": {"ln": (rng.randn(*lead, 2, 16) * 0.1).astype(
                np.float32),
                      "b": (rng.randn(*lead, 24) * 0.1).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _rel(a, b):
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _check_state(got, want):
    flat_g = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    flat_w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w)
        elif w.ndim and w.shape[-1] == 1:          # row scales
            assert np.abs(g - w).max() <= SCALE_TOL * max(
                1e-30, np.abs(w).max())
        else:
            assert _rel(g, w) <= PARAM_TOL


@pytest.mark.parametrize("use_8bit", [True, False])
def test_init_state_matches_jax(use_8bit):
    p = _tree(0)
    cfg = adamw.AdamWConfig(use_8bit=use_8bit)
    want = jax_adamw.init_state(jax.tree.map(jnp.asarray, p),
                                jax_adamw.AdamWConfig(use_8bit=use_8bit))
    got = adamw.init_state(_to_torch(p), cfg)
    assert int(got["step"]) == 0 and got["step"].dtype == torch.int32
    _check_state(got["mu"], want["mu"])


@pytest.mark.parametrize("use_8bit", [True, False])
def test_update_matches_jax_over_steps(use_8bit):
    jcfg = jax_adamw.AdamWConfig(use_8bit=use_8bit)
    cfg = adamw.AdamWConfig(use_8bit=use_8bit)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    js = jax_adamw.init_state(jp, jcfg)
    p, s = _to_torch(_tree(0)), adamw.init_state(_to_torch(_tree(0)), cfg)
    for step in range(4):
        g = _tree(10 + step)
        lr = 1e-2 * (step + 1)
        jp, js = jax_adamw.update(jp, js, jax.tree.map(jnp.asarray, g),
                                  lr=lr, cfg=jcfg)
        held = jax.tree.leaves(p) + jax.tree.leaves(s["mu"])
        p, s = adamw.update(p, s, _to_torch(g), lr=lr, cfg=cfg)
        # written in place: the same tensors come back
        assert all(a is b for a, b in zip(
            held, jax.tree.leaves(p) + jax.tree.leaves(s["mu"])))
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     p)),
                        jax.tree.leaves(jax.tree.map(np.asarray, jp))):
            assert _rel(a, b) <= PARAM_TOL
        _check_state(s["mu"], js["mu"])
        assert int(s["step"]) == int(js["step"])


def test_update_per_pe_shards_match_jax_per_shard():
    """A leaf whose last axis is sharded over 2 PEs: each PE quantizes its
    own columns, as the reference's shard_map body does per shard; the
    weight decay follows the local block's rank (cube axes excluded)."""
    jcfg = jax_adamw.AdamWConfig()
    cfg = adamw.AdamWConfig()
    full = _tree(1)
    shards = [jax.tree.map(lambda a: a[..., i * a.shape[-1] // 2:
                                          (i + 1) * a.shape[-1] // 2], full)
              for i in range(2)]
    cube = jax.tree.map(lambda *xs: np.stack(xs), *shards)   # (2, *local)
    p = _to_torch(cube)
    s = adamw.init_state(p, cfg)
    js = [jax_adamw.init_state(jax.tree.map(jnp.asarray, sh), jcfg)
          for sh in shards]
    jp = [jax.tree.map(jnp.asarray, sh) for sh in shards]
    for step in range(3):
        g = _tree(20 + step)
        gs = [jax.tree.map(lambda a: a[..., i * a.shape[-1] // 2:
                                       (i + 1) * a.shape[-1] // 2], g)
              for i in range(2)]
        p, s = adamw.update(p, s, _to_torch(jax.tree.map(
            lambda *xs: np.stack(xs), *gs)), lr=0.05, cfg=cfg, cube_ndim=1)
        for i in range(2):
            jp[i], js[i] = jax_adamw.update(
                jp[i], js[i], jax.tree.map(jnp.asarray, gs[i]), lr=0.05,
                cfg=jcfg)
            for a, b in zip(jax.tree.leaves(jax.tree.map(
                    lambda t: t[i].numpy(), p)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp[i]))):
                assert _rel(a, b) <= PARAM_TOL
            _check_state(jax.tree.map(lambda t: t[i], s["mu"]),
                         js[i]["mu"])


def test_state_defs_scale_columns_per_shard():
    from repro_torch.core.hypercube import Hypercube
    from repro_torch.models.params import ParamDef
    cube = Hypercube.build({"data": 2, "tp": 4})
    defs = {"w": ParamDef((8, 16), ("data", "tp")),
            "n": ParamDef((8,), ("data",))}
    sd = adamw.state_defs(defs, adamw.AdamWConfig(), cube=cube)
    assert sd["mu"]["w"]["m_s"] == ((8, 4), ("data", "tp"), torch.float32)
    assert sd["mu"]["n"]["v_s"] == ((2,), ("data",), torch.float32)
    assert sd["step"] == ((), (), torch.int32)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5),
                                          (100, 10000)])
def test_cosine_schedule_matches_jax(warmup, total):
    jfn = jax_adamw.cosine_schedule(3e-4, warmup, total)
    fn = adamw.cosine_schedule(3e-4, warmup, total)
    for step in (0, 1, 2, 3, 4, 5, 7, 9, 10, 50, 150, 20000):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7 * max(abs(want), 1e-30), step


def test_round_half_to_even_in_quantizers():
    """Both packages round ties to even: a moment whose companded value is
    exactly k + 0.5 lands on the even level."""
    x = torch.tensor([[0.25 ** 2, 1.0]])     # sqrt(0.0625) * 127 = 31.75
    q, _ = adamw._quant_m(x)
    jq, _ = jax_adamw._quant_m(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    assert torch.round(ties).tolist() == np.asarray(
        jnp.round(jnp.asarray(ties.numpy()))).tolist()


def _jax_update_per_shard(params, state, grads, specs, n, lr):
    """The reference's update as its shard_map body runs it on a cube of
    ``n`` PEs along ``data``: a leaf whose last axis is sharded over
    ``data`` is updated shard by shard (each its own row scales), its
    global scale arrays holding one column per shard; the other leaves'
    rows are independent, so one global update is every shard's."""
    from repro_torch.models.params import get_path, leaves, set_path
    cfg = jax_adamw.AdamWConfig()
    new_p, new_mu = {}, {}
    for path, spec in leaves(specs):
        p, mu, g = (get_path(t, path) for t in (params, state["mu"], grads))
        last = spec[-1] if spec else None
        names = (last,) if isinstance(last, str) else (last or ())
        k = n if "data" in names else 1
        outs = []
        for i in range(k):
            cut = lambda a: np.split(np.asarray(a), k, axis=-1)[i]  # noqa
            sp, ss = jax_adamw.update(
                {"x": jnp.asarray(cut(p))},
                {"mu": {"x": {q: jnp.asarray(cut(v)) for q, v in mu.items()}},
                 "step": state["step"]},
                {"x": jnp.asarray(cut(g))}, lr=lr, cfg=cfg)
            outs.append((np.asarray(sp["x"]), jax.tree.map(
                np.asarray, ss["mu"]["x"])))
        set_path(new_p, path, np.concatenate([o[0] for o in outs], -1))
        set_path(new_mu, path, {q: np.concatenate([o[1][q] for o in outs], -1)
                            for q in outs[0][1]})
    return new_p, {"mu": new_mu, "step": state["step"] + 1}


def test_from_jax_opt_state_places_the_reference_state():
    """A JAX AdamW state as the reference keeps it on a 2-PE data-parallel
    cube (one scale column per shard of a leaf's last axis), carried over
    by ``from_jax_opt_state``: the port's next update on the compact
    masters gives the reference's params and moments."""
    import dataclasses
    from repro.configs import get as jax_get
    from repro.launch.mesh import make_mesh
    from repro.models import params as jax_params
    from repro.models.topology import build_topology as jax_topology
    from repro_torch import configs
    from repro_torch.models.params import (
        from_jax_params, from_jax_opt_state, param_specs, to_global,
        trainable, tree_map)
    from repro_torch.models.topology import build_topology
    jcfg = dataclasses.replace(jax_get("qwen3-1.7b").scaled_for_smoke(),
                               tp=1)
    jtopo = jax_topology(jcfg, make_mesh((1, 1), ("data", "model")))
    jp = jax.tree.map(np.asarray, jax_params.init_params(jcfg, jtopo, 0))
    pcfg = dataclasses.replace(configs.get("qwen3-1.7b").scaled_for_smoke(),
                               tp=1)
    topo = build_topology(pcfg, 2)
    assert topo.cube.dim_sizes == (2, 1)
    specs = param_specs(pcfg, topo)
    rng = np.random.RandomState(0)
    grads = [jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.01).astype(
        np.float32), jp) for _ in range(2)]
    js = {"mu": tree_map(lambda spec, p: {
        q: np.zeros(p.shape[:-1] + (2 if "data" in str(spec[-1]) else 1,)
                    if q.endswith("_s") else p.shape,
                    np.float32 if q.endswith("_s") else np.int8)
        for q in ("m_q", "m_s", "v_q", "v_s")}, specs, jp),
        "step": jnp.zeros((), jnp.int32)}
    jp1, js1 = _jax_update_per_shard(jp, js, grads[0], specs, 2, 1e-2)
    jp2, js2 = _jax_update_per_shard(jp1, js1, grads[1], specs, 2, 1e-2)

    cpu = torch.device("cpu")
    p1 = trainable(from_jax_params(pcfg, topo, jp1, device=cpu), specs,
                   topo.cube)
    s1 = from_jax_opt_state(pcfg, topo, js1, device=cpu)
    assert int(s1["step"]) == 1
    g = trainable(from_jax_params(pcfg, topo, grads[1], device=cpu), specs,
                  topo.cube)
    p2, s2 = adamw.update(p1, s1, g, lr=1e-2, cfg=adamw.AdamWConfig(),
                          cube_ndim=topo.cube.ndim)
    for a, b in zip(jax.tree.leaves(to_global(p2, specs, topo.cube)),
                    jax.tree.leaves(jp2)):
        assert _rel(a.numpy(), b) <= PARAM_TOL
    got_mu = tree_map(lambda spec, leaf: {
        q: topo.cube.from_cube(t, spec) for q, t in leaf.items()},
        specs, _subtrees(s2["mu"], specs))
    _check_state(got_mu, js2["mu"])


def _subtrees(tree, specs):
    """``tree``'s subtrees at the leaf paths of ``specs`` (a moment dict
    per parameter), as a tree of ``specs``' structure."""
    from repro_torch.models.params import get_path, leaves, set_path
    out = {}
    for path, _ in leaves(specs):
        set_path(out, path, get_path(tree, path))
    return out


def _sliced_vs_whole(monkeypatch, use_8bit, lead, device):
    """Three steps with every leaf whole and again in slices of its
    outermost axis longer than 1; the final params and moments of both,
    as NumPy."""
    cfg = adamw.AdamWConfig(use_8bit=use_8bit)
    cn = len(lead)
    runs = []
    for elems in (1 << 40, 7):
        monkeypatch.setattr(adamw, "SLICE_ELEMS", elems)
        params = jax.tree.map(lambda t: t.to(device),
                              _to_torch(_tree(5, lead)))
        state = adamw.init_state(params, cfg)
        for s in range(3):
            grads = jax.tree.map(lambda t: t.to(device),
                                 _to_torch(_tree(10 + s, lead)))
            params, state = adamw.update(params, state, grads, lr=1e-2,
                                         cfg=cfg, cube_ndim=cn)
        runs.append(jax.tree.leaves(jax.tree.map(
            lambda t: t.cpu().numpy(), (params, state["mu"]))))
    n_slices = next((n for n in lead + (6,) if n > 1))
    assert len(adamw._slices(torch.zeros(lead + (6, 40)))) == n_slices
    return runs


@pytest.mark.parametrize("use_8bit", [True, False])
@pytest.mark.parametrize("lead", [(), (2,), (1,)])
def test_sliced_update_matches_whole_leaves(monkeypatch, use_8bit, lead):
    """A leaf updated in slices along its outermost axis longer than 1 (a
    cube axis at (2,), the first local axis at () and (1,); as a large
    leaf is, ``SLICE_ELEMS``) computes what the whole leaf does: on the
    CPU within PARAM_TOL (params, fp32 moments), SCALE_TOL (int8 scales)
    and one step of int8 (a vectorized loop rounds a short slice's tail
    elements on its scalar path, by an ulp)."""
    sliced, whole = _sliced_vs_whole(monkeypatch, use_8bit, lead, "cpu")
    for a, b in zip(sliced, whole):
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            assert _rel(a, b) <= PARAM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("use_8bit", [True, False])
def test_sliced_update_is_bit_identical_on_the_card(monkeypatch, use_8bit):
    """On the card every element goes through the same device function
    whatever the slice, and the scales are maxima: bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sliced, whole = _sliced_vs_whole(monkeypatch, use_8bit, (2,), "cuda")
    for a, b in zip(sliced, whole):
        np.testing.assert_array_equal(a, b)
