"""The port's flash attention (the plain PyTorch version that the CPU takes,
behind the same dispatch as the Hopper kernel) held against the JAX
package: the Pallas kernel in interpret mode, ``layers.reference_attention``
and ``chunked_attention(partial=True)``. Inputs come from a NumPy seed;
bf16 inputs are rounded once and handed to both. Tolerances are those of
``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16. The kernel itself
runs only on the card (``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.flash import flash_attention as pallas_flash
from repro.models.layers import (
    chunked_attention as jax_chunked, reference_attention)

from repro_torch.kernels.attention import flash, ops, ref
from repro_torch.models import layers
from repro_torch.models.topology import build_serve_topology
from repro_torch.models.config import ModelConfig

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, Sq, Sk, H, KV, hd, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    js = [jnp.asarray(t.float().numpy(), getattr(jnp, dtype)) for t in ts]
    return ts, js


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 128, 4, 1, 128),    # MQA, wide head
])
@pytest.mark.parametrize("causal,window", [(True, -1), (True, 64),
                                           (False, -1)])
def test_flash_attention_sweep(dtype, B, S, H, KV, hd, causal, window):
    (q, k, v), (jq, jk, jv) = _inputs(0, B, S, S, H, KV, hd, dtype)
    got = layers.chunked_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[dtype]
    want = reference_attention(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got.float()), _np(want), atol=tol)
    kern = pallas_flash(jq, jk, jv, causal=causal, window=window,
                        interpret=True)
    np.testing.assert_allclose(_np(got.float()), _np(kern), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 128, 8, 2, 64),     # GQA 4:1
])
@pytest.mark.parametrize("causal,window,q_off,k_off", [
    (True, -1, 64, 0),      # q block placed later in the sequence
    (True, -1, 128, 64),    # both blocks offset (a ring-attention hop)
    (True, 96, 32, 0),      # sliding window across offset positions
])
def test_flash_attention_offset_sweep(dtype, B, S, H, KV, hd, causal,
                                      window, q_off, k_off):
    (q, k, v), (jq, jk, jv) = _inputs(5, B, S, S, H, KV, hd, dtype)
    got = layers.chunked_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_off, k_offset=k_off)
    tol = TOL[dtype]
    want = jax_chunked(jq, jk, jv, causal=causal, window=window,
                       q_offset=q_off, k_offset=k_off)
    np.testing.assert_allclose(_np(got.float()), _np(want), atol=tol)
    kern = pallas_flash(jq, jk, jv, causal=causal, window=window,
                        q_offset=q_off, k_offset=k_off, interpret=True)
    np.testing.assert_allclose(_np(got.float()), _np(kern), atol=tol)


@pytest.mark.parametrize("window", [-1, 3])
def test_partial_form_matches_jax_chunked(window):
    """(acc, m, l) against ``chunked_attention(partial=True)``; the port
    flattens the JAX package's (KV, G) head axes into H."""
    B, Sq, Sk, H, KV, hd = 2, 3, 16, 4, 2, 16
    (q, k, v), (jq, jk, jv) = _inputs(7, B, Sq, Sk, H, KV, hd, "float32")
    acc, m, l = layers.chunked_attention(q, k, v, causal=True, window=window,
                                         q_offset=8, k_offset=2,
                                         partial=True)
    jacc, jm, jl = jax_chunked(jq, jk, jv, causal=True, window=window,
                               q_offset=8, k_offset=2, partial=True)
    np.testing.assert_allclose(acc.numpy(), _np(jacc).reshape(B, H, Sq, hd),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(m.numpy(), _np(jm).reshape(B, H, Sq),
                               atol=2e-5)
    np.testing.assert_allclose(l.numpy(), _np(jl).reshape(B, H, Sq),
                               atol=1e-4, rtol=1e-5)


def test_fully_masked_row_averages_v():
    """Masked scores take the finite -1e30: a row with no visible key gets
    m = -1e30, l = Sk and the mean of v, as the Pallas kernel does."""
    B, Sq, Sk, H, KV, hd = 1, 2, 8, 2, 1, 16
    (q, k, v), _ = _inputs(3, B, Sq, Sk, H, KV, hd, "float32")
    q_pos = torch.zeros((B, Sq), dtype=torch.int32)
    k_pos = torch.full((B, Sk), -1, dtype=torch.int32)
    acc, m, l = ref.flash_attention(q, k, v, q_pos, k_pos, partial=True)
    assert torch.all(m == -1e30) and torch.all(l == Sk)
    out = ref.flash_attention(q, k, v, q_pos, k_pos)
    mean_v = v.mean(dim=1, keepdim=True).expand(B, Sq, H, hd)
    torch.testing.assert_close(out, mean_v, atol=2e-6, rtol=0)


def test_masked_shard_drops_out_of_the_partial_combine():
    """Early in decode a cache shard whose whole chunk is masked has
    m = -1e30 and l = S_loc; its weight exp(m - m_all) must be 0, so the
    combined output equals attention over the visible shard alone."""
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=8,
                      head_dim=16, tp=2)
    topo = build_serve_topology(cfg, 2)
    B, H, KV, hd, S_loc = 2, 4, 2, 16, 4
    rng = np.random.RandomState(11)
    q = torch.from_numpy(rng.standard_normal(
        (1, 1, B, 1, H, hd)).astype(np.float32)).expand(1, 2, B, 1, H, hd)
    k = torch.from_numpy(rng.standard_normal(
        (1, 2, B, S_loc, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(
        (1, 2, B, S_loc, KV, hd)).astype(np.float32))
    pos = torch.tensor([1, 2]).reshape(1, 1, B, 1).expand(1, 2, B, 1)
    # shard 0 holds slots 0..3 (positions 0..3), shard 1 slots 4..7: at
    # positions 1 and 2 every key of shard 1 is in the future
    k_pos = (torch.arange(2).reshape(1, 2, 1, 1) * S_loc
             + torch.arange(S_loc)).expand(1, 2, B, S_loc)
    acc, m, l = layers.chunked_attention(q, k, v, causal=True, q_pos=pos,
                                         k_pos=k_pos, partial=True)
    assert torch.all(m[0, 1] == -1e30) and torch.all(l[0, 1] == S_loc)
    out = layers.finish_partial_attention(acc, m, l, comm=topo.comm("tp"),
                                          dtype=torch.float32)
    alone = layers.chunked_attention(q[0, :1], k[0, :1], v[0, :1],
                                     causal=True, q_pos=pos[0, :1],
                                     k_pos=k_pos[0, :1])
    torch.testing.assert_close(out[0, 0], alone[0], atol=2e-6, rtol=1e-6)
    torch.testing.assert_close(out[0, 1], alone[0], atol=2e-6, rtol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    (q, k, v), _ = _inputs(1, 1, 4, 4, 2, 1, 16, "float32")
    pos = torch.arange(4, dtype=torch.int32)[None]
    before = flash.LAUNCHES
    got = ops.flash_attention(q, k, v, pos, pos)
    assert flash.LAUNCHES == before
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, pos, pos))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k, v, pos, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("partial", [False, True])
def test_kernel_matches_plain_version_on_the_card(dtype, partial):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    (q, k, v), _ = _inputs(2, 3, 5, 37, 8, 2, 128, dtype)
    q, k, v = (t.cuda() for t in (q, k, v))
    q_pos = (torch.arange(5, device="cuda") + 30).expand(3, 5)
    k_pos = torch.arange(37, device="cuda").expand(3, 37) - 2
    q_pos, k_pos = (p.to(torch.int32).contiguous() for p in (q_pos, k_pos))
    before = flash.LAUNCHES
    got = ops.flash_attention(q, k, v, q_pos, k_pos, window=16,
                              partial=partial)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + 1
    want = ref.flash_attention(q, k, v, q_pos, k_pos, window=16,
                               partial=partial)
    tol = TOL[dtype]
    for g, w in zip(got if partial else (got,), want if partial else (want,)):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)
