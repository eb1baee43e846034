"""The port's serving slice held against the JAX package on the CPU.

Weights are the JAX package's ``init_params`` carried across with
``repro_torch.models.params.from_jax_params``; tokens come from a NumPy
seed. Both packages compute in f32 (the JAX compute dtype is set with
``monkeypatch`` and restored, so no test depends on file order), and every
comparison holds to 1e-4 * max(1, max|ref|) with identical greedy tokens.
On 1, 2 and 4 PEs at smoke size (2 KV heads), the KV projection takes the
sharded branch on 2 PEs and the per-rank slice branch on 4.
"""
import dataclasses

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

import jax
from repro_torch import configs
from repro_torch.launch import serve as launcher
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    from_jax_params, init_params, kv_is_sharded)
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology

ARCH = "qwen3-1.7b"
TOL = 1e-4          # f32 in both packages; relative to max(1, max|ref|)
CPU = torch.device("cpu")


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def _configs(pes):
    jcfg = dataclasses.replace(jax_get(ARCH).scaled_for_smoke(), tp=pes)
    pcfg = dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), tp=pes)
    return jcfg, pcfg


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bound(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("pes", [1, 2, 4])
def test_forward_logits_matches_jax(f32_reference, pes):
    jcfg, pcfg = _configs(pes)
    B, S = 2, 12
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jtopo = jax_topology(jcfg, make_mesh((1, pes), ("data", "model")))
    jparams = jax_params.init_params(jcfg, jtopo, seed=1)
    fwd = jax.jit(shard_map(
        jax_lm.Model(jcfg, jtopo).forward_logits, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  input_batch_specs(jcfg, jtopo)),
        out_specs=P(jtopo.dp, None, jtopo.tp), check_vma=False))
    ref = np.asarray(fwd(jparams, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(tokens)}))

    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, _numpy_tree(jparams), device=CPU)
    cube = topo.cube
    logits = Model(pcfg, topo, dtype=torch.float32).forward_logits(
        params, {"tokens": cube.to_cube(torch.from_numpy(tokens).long(),
                                        (topo.dp, None))})
    got = cube.from_cube(logits, (topo.dp, None, topo.tp)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= _bound(ref)


@pytest.mark.parametrize("pes", [1, 2, 4])
def test_decode_matches_jax_on_launcher_loop(f32_reference, pes):
    """The launcher's loop -- teacher-forced prompt, then greedy -- through
    the JAX ``decode_shard`` and the port's, step by step."""
    jcfg, pcfg = _configs(pes)
    B, prompt_len, gen = 2, 5, 4
    S_ctx = prompt_len + gen
    prompt = np.random.RandomState(4).randint(0, jcfg.vocab_size,
                                              (B, prompt_len))
    jtopo = jax_serve_topology(jcfg, make_mesh((1, pes), ("data", "model")))
    jplan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S_ctx,
                                        global_batch=B)
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
    assert kv_is_sharded(pcfg, topo) == (pes <= 2)
    plan = make_serve_plan(pcfg, topo, S_ctx=S_ctx, global_batch=B)
    # the port's plan is the JAX plan's geometry; its cache is the bf16 one
    assert jplan.cache_dtype == "bf16"
    for f in dataclasses.fields(plan):
        assert getattr(plan, f.name) == getattr(jplan, f.name), f.name
    server = Server(pcfg, topo, plan, dtype=torch.float32)
    params = from_jax_params(pcfg, topo, _numpy_tree(jparams), device=CPU)
    cache = init_cache(pcfg, topo, plan, dtype=torch.float32, device=CPU)
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


def test_port_decode_tracks_port_forward():
    """Teacher-forced decode reproduces the port's own forward logits
    position by position (the JAX suite's ``test_decode_matches_forward``
    contract), at f32 on 2 PEs."""
    _, pcfg = _configs(2)
    B, S = 2, 10
    ftopo = build_topology(pcfg, 2)
    stopo = build_serve_topology(pcfg, 2)
    assert ftopo.cube == stopo.cube
    params = init_params(pcfg, stopo, 7, device=CPU)
    run = launcher.serve(ARCH, batch=B, prompt_len=S, gen=1, smoke=True,
                         pes=2, device="cpu", dtype=torch.float32,
                         params=params, keep_logits=True)
    # the launcher draws its own prompt from the seed: re-run the forward
    # on exactly the tokens it decoded
    toks = torch.from_numpy(run["tokens"])[:, :S]
    ref = ftopo.cube.from_cube(
        Model(pcfg, ftopo, dtype=torch.float32).forward_logits(
            params, {"tokens": ftopo.cube.to_cube(toks, (ftopo.dp, None))}),
        (ftopo.dp, None, ftopo.tp))
    got = torch.stack(run["logits"], dim=1)
    assert got.shape == ref.shape
    bound = TOL * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= bound


def test_launcher_pe_count_does_not_change_tokens():
    runs = [launcher.serve(ARCH, batch=2, prompt_len=4, gen=3, smoke=True,
                           pes=p, device="cpu", dtype=torch.float32)
            for p in (1, 4)]
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    assert runs[0]["flash_launches"] == 0      # CPU: the plain version


def test_launcher_raises_without_cuda_unless_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="device"):
        launcher.main(["--arch", ARCH, "--smoke"])
    run = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "3", "--gen", "2",
                         "--pes", "2"])
    out = capsys.readouterr().out
    assert "generated (2, 2) tokens" in out and "ms/step" in out
    assert run["tokens"].shape == (2, 5)


def test_unported_families_raise():
    """Every family of the reference is ported: each arch id and alias
    resolves to its config; an unknown arch still raises."""
    for arch in configs.ARCH_IDS:
        assert configs.get(arch).name
    assert configs.get("jamba-1.5-large-398b").family == "hybrid"
    assert configs.get("jamba-1.5-large").mixer_pattern == "mmmmAmmm"
    assert configs.get("llava-next-34b").frontend == "patch"
    with pytest.raises(KeyError):
        configs.get("no-such-arch")
