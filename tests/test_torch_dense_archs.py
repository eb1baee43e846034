"""The port's phi3-mini-3.8b, gemma3-1b and internlm2-20b held against the
JAX package on the CPU: ``forward_logits`` and the launcher's decode loop, in f32 in both
packages, within 1e-4 * max(1, max|ref|) and with identical greedy tokens,
at 1, 2 and 4 PEs.

Each arch runs at its smoke size (head_dim 16) and again at its own head
dim (phi3-mini 96 with G = 1, gemma3 256 with G = 4), the head dims whose
flash kernel instances are new. gemma3's stock smoke config has 2 layers,
both local (its unit is one layer), so it never runs a global layer: here
it has 12, so layers 5 and 11 are global, and the sequences are longer than
the smoke window of 8, so the local windows mask keys. internlm2's own
head layout, G = 6 (48 / 8 heads), runs as 12 / 2 heads: at 4 PEs the KV
heads are replicated over tp (KV < tp) with 3 query heads a PE, as at its
own tp 16. Weights are the JAX
package's ``init_params`` carried across with ``from_jax_params``; tokens
come from a NumPy seed.
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
from repro_torch.launch import serve as launcher
from repro_torch.models.lm import Model
from repro_torch.models.params import from_jax_params
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology

TOL = 1e-4          # f32 in both packages; relative to max(1, max|ref|)
CPU = torch.device("cpu")

# (arch, overrides of its smoke config)
VARIANTS = {
    "phi3_smoke": ("phi3-mini-3.8b", {}),
    "phi3_hd96": ("phi3-mini-3.8b", {"head_dim": 96, "n_kv_heads": 4}),
    "gemma3_smoke": ("gemma3-1b", {"n_layers": 12}),
    "gemma3_hd256": ("gemma3-1b", {"n_layers": 12, "head_dim": 256}),
    "internlm2_smoke": ("internlm2-20b", {}),
    "internlm2_g6": ("internlm2-20b", {"n_heads": 12, "n_kv_heads": 2}),
}


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute (and compute-dtype cache) in f32."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def _configs(variant, pes):
    arch, over = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_get(arch).scaled_for_smoke(), tp=pes,
                               **over)
    pcfg = dataclasses.replace(configs.get(arch).scaled_for_smoke(), tp=pes,
                               **over)
    return jcfg, pcfg


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bound(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


def test_variants_run_what_they_claim():
    """hd 96 / 256 and G = 1 / 4; gemma3 has global and local layers."""
    for variant in VARIANTS:
        _, pcfg = _configs(variant, 1)
        if variant.endswith("hd96"):
            assert pcfg.head_dim == 96 and pcfg.n_heads == pcfg.n_kv_heads
        if variant.endswith("hd256"):
            assert pcfg.head_dim == 256 and pcfg.n_heads == 4 * pcfg.n_kv_heads
        if variant.endswith("g6"):
            assert pcfg.n_heads == 6 * pcfg.n_kv_heads
        if variant.startswith("gemma3"):
            w = pcfg.windows()
            assert sorted(set(w.tolist())) == [-1, 8]
            assert list(np.flatnonzero(w == -1)) == [5, 11]


@pytest.mark.parametrize("pes", [1, 2, 4])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_matches_jax(f32_reference, variant, pes):
    jcfg, pcfg = _configs(variant, pes)
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
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("pes", [1, 2, 4])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_matches_jax_on_launcher_loop(f32_reference, variant, pes):
    """The launcher's loop -- teacher-forced prompt, then greedy -- through
    the JAX ``decode_shard`` and the port's, step by step, over 12
    positions (past the smoke window of 8)."""
    jcfg, pcfg = _configs(variant, pes)
    B, prompt_len, gen = 2, 8, 4
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
    plan = make_serve_plan(pcfg, topo, S_ctx=S_ctx, global_batch=B)
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


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma3-1b"])
def test_launcher_serves_the_arch_on_the_cpu(arch, capsys):
    """``--smoke --device cpu --pes 4``: the plain version in the kernel's
    place (no launch), the same tokens as at 1 PE."""
    run = launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "6", "--gen", "3",
                         "--pes", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "flash kernel launches=0" in out
    one = launcher.serve(arch, batch=2, prompt_len=6, gen=3, smoke=True,
                         pes=1, device="cpu")
    np.testing.assert_array_equal(run["tokens"], one["tokens"])
