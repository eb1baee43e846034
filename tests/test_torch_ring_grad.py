"""Ring attention under grad: the port's ``ring_attention`` trains.

* The port's ``ring_attention`` (each hop ``ops.FlashAttentionPartial``,
  whose backward is the plain partial backward on the CPU) against
  ``jax.grad`` of JAX's ``ring_attention`` under ``shard_map`` on the
  8-ring, on the same NumPy-seeded inputs and the same output cotangent:
  dq, dk and dv in f32 within 1e-5 absolute, in bf16 within 5e-2 x
  max|jax grad|; causal, window 16 and non-causal, MHA and GQA 2:1, and a
  LOWP 2 bf16 case (its forward in the reference's mode-2 form, its
  backward in f32 in both packages).
* ``FlashAttentionPartial``'s backward holds each hop's m fixed, which is
  exact for a loss that sees a hop's (acc, m, l) only through acc e^m and
  l e^m: against plain autograd of ``ref.flash_attention(partial=True)``
  (which differentiates through m too), both composed with
  ``finish_partial_attention``'s merge, within 1e-6, a wholly masked hop
  included.
* ``chunked_attention(partial=True)`` takes grad; the int8 cache still
  refuses it (a decode-time layout in both packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.compat import shard_map
from repro.kernels.collective import ring_attention as jax_ring_attention
from repro.testing import substrate

from repro_torch.core.hypercube import Hypercube
from repro_torch.kernels.attention import ops, ref
from repro_torch.kernels.collective import ring_attention
from repro_torch.models import layers
from repro_torch.models.blocks import quantize_kv

G_RING, B, S_LOC, HD = 8, 1, 16, 16
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _jax_ring8_grads(dtype, causal, window, q, k, v, w):
    """jax.grad of sum(ring_attention(q, k, v) * w) under shard_map over
    JAX's flat 8-ring: inputs, cotangent and gradients in global layout
    ``(8, B, S_loc, heads, hd)``."""
    cube = substrate.build_cube("ring8")
    spec = substrate.global_spec(cube, q.ndim - 1)
    body = shard_map(
        lambda qi, ki, vi: jax_ring_attention(
            cube.comm("d"), qi[0], ki[0], vi[0], causal=causal,
            window=window)[None],
        mesh=cube.mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)

    def loss(qa, ka, va):
        return jnp.sum(body(qa, ka, va).astype(jnp.float32) * w)

    jd = DTYPES[dtype][1]
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jd) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_ring8_grads(dtype, causal, window, q, k, v, w):
    dt = DTYPES[dtype][0]
    leaves = [torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k, v)]
    cube = Hypercube.build({"d": G_RING})
    out = ring_attention(cube.comm("d"), *leaves, causal=causal,
                         window=window)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad.float().numpy() for t in leaves]


def _inputs(H, KV, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(G_RING, B, S_LOC, n, HD).astype(np.float32)
               for n in (H, KV, KV))
    w = rng.randn(G_RING, B, S_LOC, H, HD).astype(np.float32)
    return q, k, v, w


def _held(got, want, dtype):
    for g, j, name in zip(got, want, ("dq", "dk", "dv")):
        if dtype == "float32":
            np.testing.assert_allclose(g, j, atol=1e-5, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(
                g, j, atol=5e-2 * float(np.abs(j).max()), rtol=0,
                err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])       # MHA + GQA 2:1
@pytest.mark.parametrize("causal,window", [(True, -1), (True, 16),
                                           (False, -1)])
def test_ring_attention_grads_match_jax_grad(dtype, H, KV, causal, window):
    q, k, v, w = _inputs(H, KV)
    if dtype == "bfloat16":   # both packages start from the same bf16 values
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    got = _port_ring8_grads(dtype, causal, window, q, k, v, w)
    want = _jax_ring8_grads(dtype, causal, window, q, k, v, w)
    assert all(np.isfinite(g).all() for g in got)
    assert all(float(np.abs(j).max()) > 0 for j in want)
    _held(got, want, dtype)


def test_ring_attention_grads_match_jax_grad_in_lowp2(monkeypatch):
    """LOWP 2 on bf16: each hop's forward in the reference's mode-2 form
    (bf16 scores and p); the backward in f32 from the forward's m, held to
    jax.grad through the reference's mode-2 hops within 5e-2 of max, as
    ``test_torch_lowp.py`` holds the full form."""
    monkeypatch.setattr(jax_layers, "LOWP", 2)
    monkeypatch.setattr(layers, "LOWP", 2)
    q, k, v, w = _inputs(4, 2, seed=1)
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in (q, k, v))
    got = _port_ring8_grads("bfloat16", True, -1, q, k, v, w)
    want = _jax_ring8_grads("bfloat16", True, -1, q, k, v, w)
    _held(got, want, "bfloat16")


def _merged_loss(parts, w, dtype):
    """sum(out * w), out the hops' partials merged by
    ``finish_partial_attention`` over a 2-member communicator (one hop a
    member)."""
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    cube = Hypercube.build({"d": 2})
    out = layers.finish_partial_attention(acc, m, l, comm=cube.comm("d"),
                                          dtype=dtype)
    return (out[0].float() * w).sum()


def test_partial_backward_holds_m_fixed_exactly_for_the_merge():
    """Two hops of one query block, the second wholly masked (its keys
    all ahead: m = -1e30, p = 1): ``FlashAttentionPartial`` (m held fixed
    in its backward) against plain autograd of the partial forward
    (through m as well), both merged by ``finish_partial_attention``,
    within 1e-6. The masked hop gets no gradient."""
    Bq, S, H, KV, hd = 2, 16, 4, 2, 16
    rng = np.random.RandomState(3)
    q = rng.randn(Bq, S, H, hd).astype(np.float32)
    kv = [rng.randn(Bq, S, KV, hd).astype(np.float32) for _ in range(4)]
    w = torch.from_numpy(rng.randn(Bq, S, H, hd).astype(np.float32))
    q_pos = torch.arange(S, dtype=torch.int32).expand(Bq, S).contiguous()
    k_pos = [q_pos, q_pos + S]                 # own block, then ahead

    def grads(partial_fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in [q] + kv]
        qt, k1, v1, k2, v2 = leaves
        parts = [partial_fn(qt, kk, vv, q_pos, kp)
                 for kk, vv, kp in ((k1, v1, k_pos[0]), (k2, v2, k_pos[1]))]
        _merged_loss(parts, w, torch.float32).backward()
        return parts, [t.grad for t in leaves]

    parts, got = grads(lambda *a: ops.FlashAttentionPartial.apply(
        *a, True, -1, 0))
    _, want = grads(lambda *a: ref.flash_attention(*a, causal=True,
                                                   partial=True))
    assert (parts[1][1] == -1e30).all() and (parts[1][2] == S).all()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0)
    assert float(got[0].abs().max()) > 0
    assert (got[3] == 0).all() and (got[4] == 0).all()


def test_chunked_attention_partial_takes_grad_and_int8_refuses():
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, 8, n, 16).astype(np.float32))
               .requires_grad_() for n in (4, 2, 2))
    acc, m, l = layers.chunked_attention(q, k, v, causal=True, partial=True)
    ((acc ** 2).sum() + l.sum()).backward()
    assert m.grad_fn is None and acc.grad_fn is not None
    assert all(float(t.grad.abs().max()) > 0 for t in (q, k, v))
    (kc, ks), (vc, vs) = quantize_kv(k.detach()), quantize_kv(v.detach())
    with pytest.raises(NotImplementedError, match="decode-time layout"):
        layers.chunked_attention(q, kc, vc, partial=True, k_scale=ks,
                                 v_scale=vs)
