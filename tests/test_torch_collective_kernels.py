"""The port's collective-fused flows held to the JAX package's
(``repro.kernels.collective``) on the same NumPy-seeded inputs.

* ``ring_attention`` -- within ``RING_ATTN_TOL[dtype]`` of the full-sequence
  oracle and of JAX's ``ring_attention`` under ``shard_map``, f32 and bf16,
  MHA and GQA, causal, windowed and full. A causal ring brings every PE
  whose block precedes another's a wholly masked hop; the partial form's
  result on such a hop equals JAX's ``chunked_attention(partial=True)``
  and drops out of the merge.
* ``all_gather_matmul`` (ag_prologue) and ``matmul_reduce_scatter``
  (rs_epilogue) -- bit-identical to compute-after-gather and to
  matmul-then-reduce_scatter on integer-valued f32; ag_prologue on random
  f32 within 1e-6 relative (a GEMM over a different row count rounds
  apart, in JAX too: its own bit-identity test is red at 4.8e-7).
* ``ModelConfig.fused_comm`` -- ``forward_logits`` of the qwen3 smoke config
  at tp = 2 and cp = 2 (8 PEs, global batch 2): the port's fused forward
  within 1e-4 * max(1, max|ref|) of JAX's fused forward in f32, and within
  ``RING_ATTN_TOL["bfloat16"]`` of the port's unfused forward in bf16.
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
from repro.compat import shard_map
from repro.configs import get as jax_get
from repro.kernels.collective import ring_attention as jax_ring_attention
from repro.launch.mesh import make_mesh
from repro.models.layers import chunked_attention as jax_chunked
from repro.models.layers import reference_attention
from repro.models.topology import build_topology as jax_topology
from repro.runtime.trainer import input_batch_specs
from repro.testing import substrate

from repro_torch import configs
from repro_torch.core.comm import CommTrace
from repro_torch.core.hypercube import Hypercube
from repro_torch.kernels.collective import (
    RING_ATTN_TOL, all_gather_matmul, matmul_reduce_scatter, ring_attention)
from repro_torch.models.layers import chunked_attention, cube_matmul, rms_norm
from repro_torch.models.lm import Model
from repro_torch.models.params import from_jax_params, init_params
from repro_torch.models.topology import build_topology

CPU = torch.device("cpu")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_ring8(fn, *arrays, out_ndim):
    """shard_map ``fn`` over JAX's flat 8-ring: inputs and output in global
    layout ``(8, *payload)``."""
    cube = substrate.build_cube("ring8")
    specs = tuple(substrate.global_spec(cube, a.ndim - 1) for a in arrays)
    wrapped = jax.jit(shard_map(
        lambda *vs: fn(cube, *(v[0] for v in vs))[None], mesh=cube.mesh,
        in_specs=specs, out_specs=substrate.global_spec(cube, out_ndim),
        check_vma=False))
    return np.asarray(wrapped(*arrays).astype(jnp.float32))


# ------------------------------------------------------------ ring attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])       # MHA + GQA 2:1
@pytest.mark.parametrize("causal,window", [(True, -1), (True, 16),
                                           (False, -1)])
def test_ring_attention_within_tolerance(dtype, H, KV, causal, window):
    g, B, S_loc, hd = 8, 2, 16, 16
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(g, B, S_loc, n, hd).astype(np.float32)
               for n in (H, KV, KV))
    dt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    cube = Hypercube.build({"d": g})
    with CommTrace() as tr:
        got = ring_attention(cube.comm("d"), q, k, v, causal=causal,
                             window=window)
    assert got.dtype == dt and got.shape == q.shape
    assert [(e.flow, e.stage) for e in tr.events] == [("ring_fused", "cm")]
    got = got.float().numpy()
    qn, kn, vn = (a.float().numpy() for a in (q, k, v))
    # the oracle: the shards' blocks concatenated into the global sequence
    full = lambda a: jnp.asarray(np.moveaxis(a, 0, 1).reshape(  # noqa: E731
        B, g * S_loc, -1, hd)).astype(jnp.dtype(dtype))
    want = np.asarray(reference_attention(full(qn), full(kn), full(vn),
                                          causal=causal, window=window),
                      np.float32)
    got_full = np.moveaxis(got, 0, 1).reshape(B, g * S_loc, H, hd)
    tol = RING_ATTN_TOL[dtype]
    np.testing.assert_allclose(got_full, want, atol=tol, rtol=0)
    jref = _jax_ring8(
        lambda cube, qi, ki, vi: jax_ring_attention(
            cube.comm("d"), qi.astype(dtype), ki.astype(dtype),
            vi.astype(dtype), causal=causal, window=window),
        qn, kn, vn, out_ndim=4)
    np.testing.assert_allclose(got, jref, atol=tol, rtol=0)


def test_wholly_masked_hop_matches_jax_partial_and_drops_out():
    """Keys all ahead of the queries: the partial form gives m = -1e30,
    l = Sk and acc = sum of v (JAX's chunked_attention partial), and the
    merge weighs the hop by zero once the own block set m."""
    B, S, H, KV, hd = 2, 16, 4, 2, 16
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(B, S, n, hd).astype(np.float32)
               for n in (H, KV, KV))
    acc, m, l = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, q_offset=0, k_offset=S,
                                  partial=True)
    jacc, jm, jl = jax_chunked(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, q_offset=0,
                               k_offset=S, partial=True)
    # JAX's (B, KV, G, S, ...) layout flattens to the port's (B, H, S, ...)
    np.testing.assert_allclose(acc.numpy(),
                               np.asarray(jacc).reshape(B, H, S, hd),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm).reshape(B, H, S))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl).reshape(B, H, S))
    assert (m.numpy() == -1e30).all() and (l.numpy() == S).all()
    # the two-PE ring: PE 0's second hop is this wholly masked one
    cube = Hypercube.build({"cp": 2})
    qs, ks, vs = (torch.from_numpy(np.stack([a, a[::-1].copy()]))
                  for a in (q, k, v))
    got = ring_attention(cube.comm("cp"), qs, ks, vs, causal=True)
    own = chunked_attention(qs[0], ks[0], vs[0], causal=True)
    torch.testing.assert_close(got[0], own, rtol=0, atol=1e-6)


# ----------------------------------------------------- matmul comm fusions
def test_all_gather_matmul_bit_identical_on_integer_payloads():
    """ag_prologue with a row-wise block_fn (norm gain, up-projection) is
    bitwise equal to gathering first and computing after."""
    cube = Hypercube.build({"d": 8})
    comm = cube.comm("d")
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randint(-3, 4, (8, 2, 4, 6)).astype(np.float32))
    wu = torch.from_numpy(rng.randint(-2, 3, (8, 6, 5)).astype(np.float32))
    block_fn = lambda b: cube_matmul(b * 2.0, wu, 1)  # noqa: E731
    with CommTrace() as tr:
        fused = all_gather_matmul(comm, x, axis=1, block_fn=block_fn)
    assert [e.flow for e in tr.events] == ["ag_prologue"]
    unfused = block_fn(comm.all_gather(x, axis=1))
    assert torch.equal(fused, unfused)


def test_all_gather_matmul_float_within_rounding():
    cube = Hypercube.build({"a": 2, "b": 4})
    comm = cube.comm("01")
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 4, 2, 4, 6).astype(np.float32))
    gamma = torch.from_numpy(rng.randn(2, 4, 6).astype(np.float32))
    wu = torch.from_numpy(rng.randn(2, 4, 6, 5).astype(np.float32))
    block_fn = lambda b: cube_matmul(rms_norm(b, gamma), wu, 2)  # noqa: E731
    fused = all_gather_matmul(comm, x, axis=1, block_fn=block_fn)
    unfused = block_fn(comm.all_gather(x, axis=1))
    scale = max(1.0, float(unfused.abs().max()))
    assert float((fused - unfused).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("op", ["add", "min"])
@pytest.mark.parametrize("dims,bitmap", [({"d": 8}, "1"),
                                         ({"a": 2, "b": 2, "c": 2}, "011")])
def test_matmul_reduce_scatter_bit_identical(dims, bitmap, op):
    """rs_epilogue on integer-valued f32: the lazy-tile ring epilogue is
    bitwise equal to materializing h @ w and reduce-scattering it."""
    cube = Hypercube.build(dims)
    comm = cube.comm(bitmap)
    h = torch.from_numpy(substrate.integer_payload(cube, (16, 4), seed=5))
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randint(-3, 4, cube.dim_sizes + (4, 6))
                         .astype(np.float32))
    with CommTrace() as tr:
        fused = matmul_reduce_scatter(comm, h, w, axis=0, op=op)
    unfused = comm.reduce_scatter(cube_matmul(h, w, cube.ndim), axis=0, op=op)
    assert torch.equal(fused, unfused)
    ev = tr.events[0]
    assert ev.flow == "rs_epilogue" and ev.payload_bytes == 16 * 6 * 4


def test_matmul_reduce_scatter_rejects_indivisible():
    cube = Hypercube.build({"d": 8})
    with pytest.raises(ValueError, match="not divisible"):
        matmul_reduce_scatter(cube.comm("d"), torch.zeros(8, 12, 4),
                              torch.eye(4).expand(8, 4, 4), axis=0)


# ------------------------------------------------------- model call sites
@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute in f32."""
    for mod in (jax_params, jax_blocks, jax_lm):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def _fused_case():
    """qwen3 smoke at tp = 2 on 8 PEs with global batch 2: data 2, cp 2."""
    jcfg = dataclasses.replace(jax_get("qwen3_1_7b").scaled_for_smoke(), tp=2)
    pcfg = dataclasses.replace(configs.get("qwen3-1.7b").scaled_for_smoke(),
                               tp=2)
    topo = build_topology(pcfg, 8, global_batch=2)
    assert topo.cp == ("cp",) and topo.tp == ("tp",)
    tokens = np.random.RandomState(6).randint(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    return jcfg, pcfg, topo, tokens


def _port_logits(cfg, topo, params, tokens, dtype):
    cube = topo.cube
    logits = Model(cfg, topo, dtype=dtype).forward_logits(
        params, {"tokens": cube.to_cube(torch.from_numpy(tokens).long(),
                                        (topo.dp, None))})
    return cube.from_cube(logits, (topo.dp, None, topo.tp)).float().numpy()


def test_fused_forward_matches_jax_fused(f32_reference):
    jcfg, pcfg, topo, tokens = _fused_case()
    jtopo = jax_topology(jcfg, make_mesh((2, 4), ("data", "model")),
                         global_batch=2)
    assert jtopo.cube.dim_names == topo.cube.dim_names
    jparams = jax_params.init_params(jcfg, jtopo, seed=0)
    fcfg = dataclasses.replace(jcfg, fused_comm=True)
    fwd = jax.jit(shard_map(
        jax_lm.Model(fcfg, jtopo).forward_logits, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(fcfg, jtopo),
                  input_batch_specs(fcfg, jtopo)),
        out_specs=P(jtopo.dp, None, jtopo.tp), check_vma=False))
    ref = np.asarray(fwd(jparams, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(tokens)}))
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    with CommTrace() as tr:
        got = _port_logits(dataclasses.replace(pcfg, fused_comm=True), topo,
                           params, tokens, torch.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    flows = {e.flow for e in tr.events}
    assert {"ring_fused", "ag_prologue", "rs_epilogue"} <= flows


def test_fused_forward_matches_unfused_bf16():
    _, pcfg, topo, tokens = _fused_case()
    params = init_params(pcfg, topo, seed=1, device=CPU)
    base = _port_logits(pcfg, topo, params, tokens, torch.bfloat16)
    fused = _port_logits(dataclasses.replace(pcfg, fused_comm=True), topo,
                         params, tokens, torch.bfloat16)
    assert np.isfinite(fused).all()
    np.testing.assert_allclose(fused, base, atol=RING_ATTN_TOL["bfloat16"],
                               rtol=0)


@pytest.mark.parametrize("flow,primitive", [("ring_fused", "all_gather"),
                                            ("ag_prologue", "all_gather"),
                                            ("rs_epilogue",
                                             "reduce_scatter")])
def test_planner_prices_fused_flows_as_direct(flow, primitive):
    """A fused flow's bytes are the direct flow's (the reference's model),
    its stage is the registry's ``cm``, and ``plan`` never picks it on
    bytes alone (the tie-break away from fused flows)."""
    from repro.core import planner as jax_planner
    from repro.testing.substrate import fake_cube
    from repro_torch.core import planner
    dims = {"pod": 2, "dp": 4, "tp": 2}
    jcube = fake_cube((2, 4, 2), ("pod", "data", "model"), dims)
    cube = Hypercube.build(dims, pods=2)
    for sel in (("tp",), ("dp", "tp"), ("pod", "dp")):
        for payload in (4096.0, 1 << 24):
            want = jax_planner.estimate(jcube, primitive, sel, payload, flow)
            got = planner.estimate(cube, primitive, sel, payload, flow)
            direct = planner.estimate(cube, primitive, sel, payload,
                                      "direct")
            assert (got.algorithm, got.stage) == (want.algorithm, "cm")
            assert want.stage == "cm"
            assert got.ici_bytes == pytest.approx(want.ici_bytes)
            assert got.dcn_bytes == pytest.approx(want.dcn_bytes)
            assert (got.ici_bytes, got.dcn_bytes) == (direct.ici_bytes,
                                                      direct.dcn_bytes)
            assert planner.plan(cube, primitive, sel,
                                payload).algorithm != flow
    with pytest.raises(ValueError, match="not"):
        planner.estimate(cube, "all_reduce", ("tp",), 64.0, flow)
