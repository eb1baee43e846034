"""The port's RWKV6 recurrence (``repro_torch.kernels.rwkv6``) held against
the JAX package on the CPU.

The plain version (``ref.rwkv6_chunked``, the CPU path of the dispatch)
against the Pallas kernel in interpret mode over the sweep of
``tests/test_kernels.py`` on that test's own inputs (5e-4 in f32, 5e-2 in
bf16, as that test holds it), against ``repro.models.ssm.rwkv6_chunked``
for the output and the final state with a state coming in, and against the
naive sequential oracle. The chunk rule is the JAX package's: 48 steps run
one chunk of 48, 144 two of 72, and 129 raise. Other inputs come from
NumPy seeds; unless stated, comparisons hold to 1e-4 * max(1, max|ref|).
The kernel itself runs only on the card (``cuda`` marker).

Under the sweep's strong decay, logw = -exp(0.5 N(0, 1)), a chunk of 64
steps can take the cumulative log decay near -88, where e^{cum} is an f32
subnormal. XLA on the CPU flushes subnormals to zero, so there both JAX
chunked forms drop those terms and leave the sequential oracle by up to
0.34 (NumPy seed 3 at (2, 64, 4, 32)); PyTorch keeps subnormals, and the
plain version stays on the oracle. The sweep test holds those rows to
the oracle and ``test_plain_matches_sequential_oracle_near_f32_limit``
holds a whole such draw there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.rwkv6 import rwkv6_chunked as rwkv_pallas
from repro.models import ssm as jax_ssm

from repro_torch.kernels.rwkv6 import ops, ref, rwkv6
from repro_torch.models import ssm

TOL = 1e-4
SWEEP = [(1, 128, 2, 16, 32), (2, 64, 4, 32, 64), (1, 256, 1, 64, 64)]


def _inputs(seed, B, S, H, K, *, strong=True, state=False):
    """r, k, v ~ N(0, 1); logw = -exp(0.5 N(0, 1)) (the JAX sweep's strong
    decay) or the model's decay range (-exp of [-6, -1]); u ~ 0.1 N(0, 1);
    with ``state``, an N(0, 1) state coming in."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32)
               for _ in range(3))
    if strong:
        logw = -np.exp(0.5 * rng.standard_normal((B, S, H, K)))
    else:
        logw = -np.exp(rng.uniform(-6.0, -1.0, (B, S, H, K)))
    u = 0.1 * rng.standard_normal((H, K))
    st = rng.standard_normal((B, H, K, K)) if state else None
    f32 = (lambda a: None if a is None else a.astype(np.float32))
    return r, k, v, f32(logw), f32(u), f32(st)


def _bound(ref_out, tol=TOL):
    return tol * max(1.0, float(np.abs(ref_out).max()))


def _torch(*arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype)
            for a in arrays]


def _subnormal_rows(r, logw, chunk):
    """(B, S, H) rows whose decayed receptance r_t e^{cum_{t-1}} (the decay
    from the chunk's start) is an f32 subnormal in some channel of a
    strongly decayed chunk: there XLA's flush to zero drops the row's
    terms in the JAX chunked forms."""
    B, S, H, K = logw.shape
    lw = logw.reshape(B, S // chunk, chunk, H, K).astype(np.float64)
    before = (np.cumsum(lw, axis=2) - lw).reshape(B, S, H, K)
    qd = np.abs(r.astype(np.float64)) * np.exp(before)
    return ((before < -80) & (qd < np.finfo(np.float32).tiny)).any(-1)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,K,chunk", SWEEP)
def test_plain_matches_pallas_kernel_sweep(dtype, B, S, H, K, chunk):
    """``test_rwkv6_kernel_sweep``'s inputs, drawn as that test draws
    them, through the Pallas kernel (interpret mode) and the plain
    version, which agree at that test's tolerance on every row where the
    JAX side stays in f32's normal range; on the rows where it flushes a
    subnormal decay (two of 256 at (1, 256, 1, 64)) the plain version
    agrees with the sequential oracle instead."""
    ks = jax.random.split(jax.random.PRNGKey(3), 5)
    jr = jax.random.normal(ks[0], (B, S, H, K), dtype)
    jk = jax.random.normal(ks[1], (B, S, H, K), dtype)
    jv = jax.random.normal(ks[2], (B, S, H, K), dtype)
    jlw = -jnp.exp(jax.random.normal(ks[3], (B, S, H, K)) * 0.5).astype(
        jnp.float32)
    ju = (jax.random.normal(ks[4], (H, K)) * 0.1).astype(dtype)
    want = np.asarray(rwkv_pallas(jr, jk, jv, jlw, ju, chunk=chunk,
                                  interpret=True), np.float32)
    oracle = np.asarray(jax_ssm.rwkv6_reference(jr, jk, jv, jlw, ju)[0],
                        np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tr, tk, tv, tu = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(tdt) for a in (jr, jk, jv, ju))
    got, _ = ref.rwkv6_chunked(tr, tk, tv,
                               torch.from_numpy(np.array(jlw)), tu,
                               chunk=chunk)
    assert got.dtype == tdt
    got = got.float().numpy()
    # bf16: that test's 5e-2, plus one bf16 ulp (2^-7 relative at most):
    # outputs reach 75, where one f32 value rounds to either side of a
    # bf16 boundary when two f32 computations differ in the last bits
    tol, rtol = (5e-2, 2.0 ** -7) if dtype == jnp.bfloat16 else (5e-4, 0)
    flushed = _subnormal_rows(np.array(jr.astype(jnp.float32)),
                              np.array(jlw), chunk)
    assert flushed.sum() <= 2
    np.testing.assert_allclose(got[~flushed], want[~flushed], atol=tol,
                               rtol=rtol)
    np.testing.assert_allclose(got[flushed], oracle[flushed], atol=tol,
                               rtol=rtol)


@pytest.mark.parametrize("B,S,H,K,chunk", SWEEP + [(2, 48, 2, 16, 64),
                                                   (1, 144, 2, 16, 64)])
def test_plain_matches_jax_chunked_with_state(B, S, H, K, chunk):
    """Output and final state of ``ssm.rwkv6_chunked``, with a state in,
    under the model's decay range (see the module note for the strong
    decay)."""
    r, k, v, logw, u, st = _inputs(5, B, S, H, K, strong=False, state=True)
    jo, js = jax_ssm.rwkv6_chunked(*(jnp.asarray(a) for a in
                                     (r, k, v, logw, u)),
                                   state=jnp.asarray(st), chunk=chunk)
    jo, js = np.asarray(jo), np.asarray(js)
    o, s = ref.rwkv6_chunked(*_torch(r, k, v, logw, u),
                             state=torch.from_numpy(st), chunk=chunk)
    assert s.dtype == torch.float32
    assert np.abs(o.numpy() - jo).max() <= _bound(jo)
    assert np.abs(s.numpy() - js).max() <= _bound(js)


@pytest.mark.parametrize("state", [False, True])
def test_plain_state_matches_sequential_reference(state):
    """Chunked output and final state against the naive step loop, in
    both packages' oracles (the port's ``ssm.rwkv6_reference``)."""
    r, k, v, logw, u, st = _inputs(7, 2, 96, 2, 16, strong=False,
                                   state=state)
    tst = None if st is None else torch.from_numpy(st)
    o, s = ref.rwkv6_chunked(*_torch(r, k, v, logw, u), state=tst, chunk=32)
    ro, rs = ssm.rwkv6_reference(*_torch(r, k, v, logw, u), state=tst)
    jo, js = jax_ssm.rwkv6_reference(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)),
        state=None if st is None else jnp.asarray(st))
    assert np.abs(rs.numpy() - np.asarray(js)).max() <= _bound(np.asarray(js))
    assert np.abs(ro.numpy() - np.asarray(jo)).max() <= _bound(np.asarray(jo))
    assert np.abs(s.numpy() - rs.numpy()).max() <= _bound(rs.numpy())
    assert np.abs(o.numpy() - ro.numpy()).max() <= _bound(ro.numpy())


def test_plain_matches_sequential_oracle_near_f32_limit():
    """The strong-decay draw whose chunk of 64 takes the cumulative log
    decay to about -86: the plain version stays on the step loop."""
    r, k, v, logw, u, _ = _inputs(3, 2, 64, 4, 32)
    assert np.cumsum(logw, axis=1).min() < -85
    o, s = ref.rwkv6_chunked(*_torch(r, k, v, logw, u), chunk=64)
    jo, js = (np.asarray(a) for a in jax_ssm.rwkv6_reference(
        *(jnp.asarray(a) for a in (r, k, v, logw, u))))
    assert np.abs(o.numpy() - jo).max() <= _bound(jo)
    assert np.abs(s.numpy() - js).max() <= _bound(js)


@pytest.mark.parametrize("S", [1, 15, 16, 17, 32, 37, 48])
def test_plain_matches_sequential_oracle_at_the_cards_lengths(S):
    """The lengths of the card's cases around the kernel's 16-step
    sub-chunk, and the served 32 and 48, each one chunk of the plain
    version, with a state in and one u per pair of batch rows: output and
    final state against JAX's step loop, group by group."""
    r, k, v, logw, _, st = _inputs(13, 4, S, 2, 16, strong=False,
                                   state=True)
    u = (0.1 * np.random.RandomState(S).standard_normal((2, 2, 16))
         ).astype(np.float32)
    o, s = ref.rwkv6_chunked(*_torch(r, k, v, logw, u),
                             state=torch.from_numpy(st), chunk=S)
    for g in range(2):
        rows = slice(2 * g, 2 * g + 2)
        jo, js = (np.asarray(a) for a in jax_ssm.rwkv6_reference(
            *(jnp.asarray(a[rows]) for a in (r, k, v, logw)),
            jnp.asarray(u[g]), state=jnp.asarray(st[rows])))
        assert np.abs(o[rows].numpy() - jo).max() <= _bound(jo)
        assert np.abs(s[rows].numpy() - js).max() <= _bound(js)


@pytest.mark.parametrize("S,C", [(48, 48), (144, 72), (32, 32), (256, 64)])
def test_chunk_rule_matches_jax(S, C):
    assert ref.chunk_len(S) == C


def test_chunk_rule_raises_where_jax_asserts():
    r, k, v, logw, u, _ = _inputs(1, 1, 129, 1, 16)
    with pytest.raises(AssertionError):
        jax_ssm.rwkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)))
    with pytest.raises(ValueError, match="129 steps"):
        ref.rwkv6_chunked(*_torch(r, k, v, logw, u))
    with pytest.raises(ValueError, match="129 steps"):
        ssm.rwkv6_chunked(*_torch(r, k, v, logw, u))


def test_grouped_u_and_folded_batch():
    """The model folds the cube's PEs into the batch: u (G, H, K) gives
    batch row n the bonus of row n // (B / G), and ``ssm.rwkv6_chunked``
    folds (*cube, B) leading axes with one u per PE."""
    r, k, v, logw, _, st = _inputs(9, 8, 32, 2, 16, strong=False,
                                   state=True)
    u = (0.1 * np.random.RandomState(1).standard_normal((4, 2, 16))
         ).astype(np.float32)
    o, s = ref.rwkv6_chunked(*_torch(r, k, v, logw, u),
                             state=torch.from_numpy(st))
    for g in range(4):
        rows = slice(2 * g, 2 * g + 2)
        jo, js = jax_ssm.rwkv6_chunked(
            *(jnp.asarray(a[rows]) for a in (r, k, v, logw)),
            jnp.asarray(u[g]), state=jnp.asarray(st[rows]))
        assert np.abs(o[rows].numpy() - np.asarray(jo)).max() <= _bound(jo)
        assert np.abs(s[rows].numpy() - np.asarray(js)).max() <= _bound(js)
    lead = (2, 2, 2)
    fo, fs = ssm.rwkv6_chunked(
        *(t.reshape(lead + t.shape[1:]) for t in _torch(r, k, v, logw)),
        torch.from_numpy(u).reshape(2, 2, 2, 16),
        state=torch.from_numpy(st).reshape(lead + st.shape[1:]))
    torch.testing.assert_close(fo.reshape(o.shape), o, rtol=0, atol=0)
    torch.testing.assert_close(fs.reshape(s.shape), s, rtol=0, atol=0)


def test_dispatch_takes_plain_version_on_cpu():
    r, k, v, logw, u, _ = _inputs(2, 1, 16, 2, 16)
    n0 = rwkv6.LAUNCHES
    o, s = ops.rwkv6_chunked(*_torch(r, k, v, logw, u))
    want = ref.rwkv6_chunked(*_torch(r, k, v, logw, u))
    assert rwkv6.LAUNCHES == n0
    torch.testing.assert_close(o, want[0], rtol=0, atol=0)
    torch.testing.assert_close(s, want[1], rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    r, k, v, logw, u, _ = _inputs(2, 1, 16, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6.rwkv6_chunked(*_torch(r, k, v, logw, u))


# the card's cases: B, S, H, K, the plain version's chunk, strong decay,
# state in, u groups (0: one u for the batch). The full head shape with a
# state in, the JAX sweep, lengths around the 16-step sub-chunk (1, 15, 16,
# 17, 37), G > 1, K = 16 and 32, grids under and over the 132 SMs
CARD_CASES = ([(4, 512, 64, 64, 64, False, True, 0),
               (2, 144, 4, 64, 64, False, True, 0)]
              + [c + (True, False, 0) for c in SWEEP]
              + [(1, 1, 4, 64, 1, False, True, 0),
                 (1, 1, 2, 16, 1, False, False, 0),
                 (2, 15, 4, 64, 15, False, True, 2),
                 (2, 16, 4, 32, 16, False, True, 0),
                 (2, 17, 4, 16, 17, False, True, 2),
                 (3, 17, 1, 32, 17, False, False, 3),
                 (4, 37, 2, 64, 37, False, True, 4),
                 (2, 40, 48, 64, 40, False, True, 2),
                 (8, 48, 32, 64, 48, False, True, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(dtype):
    """The kernel against its plain version on the card, on o and the
    final state, over CARD_CASES."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    tol = 5e-2 if dtype == torch.bfloat16 else 5e-4
    for B, S, H, K, chunk, strong, state, G in CARD_CASES:
        r, k, v, logw, u, st = _inputs(11, B, S, H, K, strong=strong,
                                       state=state)
        if G:
            u = (0.1 * np.random.RandomState(G).standard_normal((G, H, K))
                 ).astype(np.float32)
        x = [t.cuda() for t in _torch(r, k, v, u, dtype=dtype)]
        lw = torch.from_numpy(logw).cuda()
        s0 = None if st is None else torch.from_numpy(st).cuda()
        n0 = rwkv6.LAUNCHES
        o, s = ops.rwkv6_chunked(x[0], x[1], x[2], lw, x[3], s0)
        torch.cuda.synchronize()
        assert rwkv6.LAUNCHES == n0 + 1
        wo, ws = ref.rwkv6_chunked(x[0], x[1], x[2], lw, x[3], s0,
                                   chunk=chunk)
        assert o.dtype == dtype and s.dtype == torch.float32
        for got, want in ((o, wo), (s, ws)):
            want = want.float()
            scale = max(1.0, float(want.abs().max()))
            assert float((got.float() - want).abs().max()) <= tol * scale
