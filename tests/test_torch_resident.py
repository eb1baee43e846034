"""Resident serve weights (``Model(resident=)`` / ``Server(resident=)``):
the parameter specs with the ``data`` axis dropped (``params.drop_axis``),
each leaf placed whole on every data PE as a stride-0 view of one compact
block, so decode gathers no weight over ``data``.

On the CPU, qwen3-1.7b's smoke config on a serve cube of data 2 x tp 2
(``serve_tp=2`` at 4 PEs, the batch sharded over ``data``): resident
decode bit-identical to the FSDP decode on the same global weights, no
``data`` all_gather in its ``CommTrace`` (the FSDP run has one per weight
leaf a layer), the masters compact over ``data``, and both against the JAX
package's ``Server(resident=True)`` in f32 within 1e-4 x max(1,
max|ref|).
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
from repro_torch.core.comm import CommTrace
from repro_torch.launch import serve as launcher
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    drop_axis, from_jax_params, init_params, leaves, param_specs)
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology

ARCH = "qwen3-1.7b"
TOL = 1e-4
CPU = torch.device("cpu")
B, PROMPT, GEN = 2, 6, 4


@pytest.fixture
def f32_reference(monkeypatch):
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def _cfg(pkg_get):
    return dataclasses.replace(pkg_get(ARCH).scaled_for_smoke(), tp=2,
                               serve_tp=2)


def _decode(resident, params, dtype=torch.float32, trace=None):
    """The launcher's loop at data 2 x tp 2; every step's global logits
    and the data all_gathers each step dispatched."""
    cfg = _cfg(configs.get)
    topo = build_serve_topology(cfg, 4)
    assert dict(zip(topo.cube.dim_names, topo.cube.dim_sizes)) == {
        "data": 2, "tp": 2}
    plan = make_serve_plan(cfg, topo, S_ctx=PROMPT + GEN, global_batch=B)
    assert plan.batch_axes == ("data",)
    server = Server(cfg, topo, plan, dtype=dtype, resident=resident)
    cache = init_cache(cfg, topo, plan, dtype=dtype, device=CPU)
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, (B, PROMPT))
    cube, ba = topo.cube, plan.batch_axes
    toks, out, gathers = prompt[:, 0], [], []
    for t in range(PROMPT + GEN - 1):
        with CommTrace() as trc:
            logits, cache = server.decode_shard(
                params, cache, cube.to_cube(torch.from_numpy(toks), (ba,)),
                cube.to_cube(torch.full((B,), t), (ba,)))
        gathers.append(sum(e.primitive == "all_gather" and e.dims == ("data",)
                           for e in trc.events))
        g = cube.from_cube(logits, (ba, topo.tp))
        out.append(g)
        nxt = g.argmax(-1).numpy()
        toks = prompt[:, t + 1] if t + 1 < PROMPT else nxt
    return torch.stack(out), gathers


def _params(resident, jparams=None):
    cfg = _cfg(configs.get)
    topo = build_serve_topology(cfg, 4)
    if jparams is None:
        return init_params(cfg, topo, 3, device=CPU, resident=resident)
    return from_jax_params(cfg, topo, jparams, device=CPU, resident=resident)


def test_resident_specs_and_masters():
    cfg = _cfg(configs.get)
    topo = build_serve_topology(cfg, 4)
    specs = param_specs(cfg, topo)
    rspecs = param_specs(cfg, topo, resident=True)
    assert rspecs == drop_axis(specs) == Model(
        cfg, topo, resident=True).specs
    assert not any("data" in str(s) for _, s in leaves(rspecs))
    a, b = _params(False), _params(True)
    cube = topo.cube
    for (path, x), (_, y), (_, s), (_, rs) in zip(
            leaves(a), leaves(b), leaves(specs), leaves(rspecs)):
        # the same global weights; the resident leaf is one block over data
        assert torch.equal(cube.from_cube(x, s), cube.from_cube(y, rs)), path
        assert y.stride(cube.dim_names.index("data")) == 0, path


def test_resident_decode_bit_identical_and_gathers_nothing_over_data():
    fsdp, g_fsdp = _decode(False, _params(False))
    res, g_res = _decode(True, _params(True))
    assert torch.equal(fsdp, res)
    assert set(g_res) == {0}
    assert min(g_fsdp) > 0


def test_resident_decode_matches_jax(f32_reference):
    jcfg = _cfg(jax_get)
    jtopo = jax_serve_topology(jcfg, make_mesh((1, 4), ("data", "model")))
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=PROMPT + GEN,
                                        global_batch=B)
    jparams = jax_params.init_params(jcfg, jtopo, seed=2)
    specs = jax_params.drop_axis(jax_params.param_specs(jcfg, jtopo))
    cspecs = jax_serving.cache_specs(jcfg, jtopo, jplan)
    jba = jplan.batch_axes
    step = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, jplan, resident=True).decode_shard,
        mesh=jtopo.cube.mesh, in_specs=(specs, cspecs, P(jba), P(jba)),
        out_specs=(P(jba, jtopo.tp), cspecs), check_vma=False))
    jcache = jax_serving.init_cache(jcfg, jtopo, jplan)
    prompt = np.random.RandomState(5).randint(0, jcfg.vocab_size,
                                              (B, PROMPT))
    toks, ref = prompt[:, 0], []
    for t in range(PROMPT + GEN - 1):
        logits, jcache = step(jparams, jcache, jnp.asarray(toks, jnp.int32),
                              jnp.full((B,), t, jnp.int32))
        logits = np.asarray(logits)
        ref.append(logits)
        toks = prompt[:, t + 1] if t + 1 < PROMPT else logits.argmax(-1)
    ref = np.stack(ref)
    got, gathers = _decode(True, _params(True, jax.tree.map(np.asarray,
                                                            jparams)))
    assert set(gathers) == {0}
    assert np.abs(got.numpy() - ref).max() <= TOL * max(1.0,
                                                        np.abs(ref).max())
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


def test_launcher_serves_resident_and_int8_on_the_cpu(capsys):
    """``--resident`` and ``--cache-dtype int8``: the resident run's tokens
    are the FSDP run's; the int8 run serves (the plain int8 decode form in
    the kernel's place)."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen", "3", "--pes", "2"]
    plain = launcher.main(base)
    res = launcher.main(base + ["--resident"])
    np.testing.assert_array_equal(plain["tokens"], res["tokens"])
    q = launcher.main(base + ["--cache-dtype", "int8"])
    out = capsys.readouterr().out
    assert "cache=8 int8" in out and "int8 decode form 0" in out
    assert q["cache"]["p0"]["k"].dtype == torch.int8
    assert (q["tokens"][:, :5] == plain["tokens"][:, :5]).all()
