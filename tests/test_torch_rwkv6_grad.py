"""The RWKV6 recurrence under autograd, held on the CPU.

``ref.rwkv6_chunked_backward`` is the plain version of the backward kernel
(``csrc/rwkv6_bwd.cu``): the same two passes over the kernels' 16-step
sub-chunks -- the state's gradient at each 64-step chunk's end
(``ref.state_grads``), then each chunk on its own from the state the
forward saves at its start (``ref.chunk_states``) and that gradient
(``ref.chunk_grads``). It is held to autograd of the plain forward
``ref.rwkv6_chunked`` within 1e-5 x max(1, max|ref|) per output -- K = 16,
32 and 64, a state in and its gradient out, u of shape (H, K) and (G, H,
K), lengths off the sub-chunk and around the 64-step chunk, and the JAX
sweep's strong decay (there the forward runs chunks of at most 16 steps,
which keeps e^{-cum} inside f32) -- and to ``jax.vjp`` of
the JAX package's ``ssm.rwkv6_chunked`` within 1e-4 x max(1, max|ref|), on
the model's moderate decay: XLA on the CPU flushes subnormals to zero, and
under the strong decay a chunk of 64 takes e^{cum} there (see
``tests/test_torch_rwkv6.py``), so those rows are not a reference. Pass 1's
gradients are autograd's with respect to a state placed at each boundary;
pass 2 gives the same bits whatever order it takes the chunks in.
``RWKV6Chunked``, the differentiable form the model trains through, equals
the plain backward bit for bit on the CPU. The kernel itself runs only on
the card (``cuda`` marker). Inputs come from NumPy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm

from repro_torch.kernels.rwkv6 import ops, ref, rwkv6, rwkv6_bwd
from repro_torch.models import ssm

AUTOGRAD_TOL = 1e-5
JAX_TOL = 1e-4
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate")
# B, S, H, K, strong decay, state in, u groups (0: one u of (H, K))
CASES = [(2, 37, 2, 16, False, True, 0),
         (2, 64, 3, 32, True, True, 2),
         (1, 17, 1, 64, True, False, 0),
         (4, 1, 2, 16, False, True, 4),
         (2, 15, 2, 32, False, False, 2),
         (2, 16, 2, 64, False, True, 0),
         (1, 40, 2, 16, True, True, 0),
         (2, 144, 1, 32, False, True, 0),
         (2, 63, 2, 16, False, True, 0),
         (2, 64, 2, 32, False, False, 2),
         (2, 65, 2, 16, False, True, 2),
         (1, 129, 2, 16, False, True, 0)]


def _inputs(seed, B, S, H, K, strong, state, G):
    """r, k, v, do ~ N(0, 1); logw the sweep's strong decay -exp(0.5
    N(0, 1)) or the model's -exp(U(-6, -1)); u ~ 0.1 N(0, 1) of (H, K) or
    (G, H, K); an N(0, 1) state and its gradient, or None."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = f(B, S, H, K), f(B, S, H, K), f(B, S, H, K)
    if strong:
        logw = -np.exp(0.5 * f(B, S, H, K))
    else:
        logw = -np.exp(rng.uniform(-6.0, -1.0, (B, S, H, K)))
    u = 0.1 * (f(G, H, K) if G else f(H, K))
    st = f(B, H, K, K) if state else None
    do, ds = f(B, S, H, K), f(B, H, K, K)
    f32 = (lambda a: None if a is None else a.astype(np.float32))
    return [f32(a) for a in (r, k, v, logw, u, st, do, ds)]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _chunk(S, strong=False):
    """The plain forward's chunk: under the strong decay the largest
    divisor of S up to 16 (16 where it divides S), which keeps e^{-cum}
    inside f32; else 64 where S splits into chunks of up to 64 (the
    reference's rule), else the largest divisor of S up to 64 (43 for
    S = 129)."""
    if strong:
        return max(c for c in range(1, 17) if S % c == 0)
    try:
        ref.chunk_len(S)
        return 64
    except ValueError:
        return max(c for c in range(1, 65) if S % c == 0)


def _autograd(r, k, v, logw, u, st, do, ds, strong):
    """Gradients of sum(o * do) + sum(state * ds) by autograd of the plain
    forward."""
    chunk = _chunk(r.shape[1], strong)
    xs = [_t(a).requires_grad_() for a in (r, k, v, logw, u)]
    s0 = None if st is None else _t(st).requires_grad_()
    o, s = ref.rwkv6_chunked(*xs, state=s0, chunk=chunk)
    loss = (o * _t(do)).sum() + (s * _t(ds)).sum()
    grads = torch.autograd.grad(loss, xs + ([] if s0 is None else [s0]))
    return list(grads) + ([] if s0 is not None else [None])


def _held(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape, name
        bound = tol * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= bound, (
            name, float(np.abs(g - w).max()), bound)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_autograd(case):
    *shape, strong, state, G = case
    r, k, v, logw, u, st, do, ds = _inputs(sum(shape), *shape, strong,
                                           state, G)
    got = ref.rwkv6_chunked_backward(*(_t(a) for a in (
        r, k, v, logw, u, st, do, ds)))
    _held(got, _autograd(r, k, v, logw, u, st, do, ds, strong),
          AUTOGRAD_TOL)


def test_plain_backward_without_the_final_states_gradient():
    """dstate None is a zero gradient of the final state."""
    r, k, v, logw, u, st, do, _ = _inputs(3, 2, 33, 2, 16, False, True, 0)
    ins = [_t(a) for a in (r, k, v, logw, u, st, do)]
    got = ref.rwkv6_chunked_backward(*ins, None)
    want = ref.rwkv6_chunked_backward(*ins, torch.zeros(2, 2, 16, 16))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_chunk_states_are_the_recurrences_states():
    """Entry i of ``chunk_states`` is the final state of the first 64 i
    steps."""
    r, k, v, logw, u, st, _, _ = _inputs(4, 2, 150, 2, 16, False, True, 0)
    states = ref.chunk_states(_t(k), _t(v), _t(logw), _t(st))
    assert states.shape == (2, 2, 3, 16, 16)
    torch.testing.assert_close(states[:, :, 0], _t(st), rtol=0, atol=0)
    for i, n in ((1, 64), (2, 128)):
        _, s = ssm.rwkv6_reference(*(_t(a[:, :n]) for a in (r, k, v, logw)),
                                   _t(u), state=_t(st))
        torch.testing.assert_close(states[:, :, i], s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,H,K,state", [(2, 129, 2, 16, True),
                                           (1, 200, 1, 32, False),
                                           (2, 65, 2, 16, True)])
def test_state_grads_are_autograds_at_each_boundary(B, S, H, K, state):
    """Pass 1's gradient at the end of chunk c - 1 (step 64 c) is
    autograd's gradient of sum(o * do) + sum(s_out * dstate) with respect
    to a leaf state placed at step 64 c, the steps after it run by the
    sequential recurrence; its step-0 gradient is the incoming state's."""
    r, k, v, logw, u, st, do, ds = (_t(a) for a in _inputs(
        S + K, B, S, H, K, False, state, 0))
    ends, d0 = ref.state_grads(r, logw, do, ds)
    n_save = -(-S // ref.SAVE)
    assert ends.shape == (B, H, n_save, K, K)
    torch.testing.assert_close(ends[:, :, -1], ds, rtol=0, atol=0)
    for c in range(n_save):
        t0 = ref.SAVE * c
        s_c = torch.zeros((B, H, K, K)) if st is None else st
        if t0:
            with torch.no_grad():
                _, s_c = ssm.rwkv6_reference(
                    r[:, :t0], k[:, :t0], v[:, :t0], logw[:, :t0], u,
                    state=st)
        leaf = s_c.clone().requires_grad_()
        o, s = ssm.rwkv6_reference(r[:, t0:], k[:, t0:], v[:, t0:],
                                   logw[:, t0:], u, state=leaf)
        loss = (o * do[:, t0:]).sum() + (s * ds).sum()
        (want,) = torch.autograd.grad(loss, [leaf])
        got = d0 if c == 0 else ends[:, :, c - 1]
        bound = AUTOGRAD_TOL * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= bound, c


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_chunk_grads_do_not_depend_on_the_chunks_order(order):
    """Pass 2 run over the chunks last to first, or in an order drawn from
    a NumPy seed, gives the bits of the first-to-last run: no chunk reads
    another's result, which the kernel's one CTA per chunk relies on."""
    r, k, v, logw, u, st, do, ds = (_t(a) for a in _inputs(
        8, 2, 300, 2, 16, True, True, 2))
    states = ref.chunk_states(k, v, logw, st)
    ends, _ = ref.state_grads(r, logw, do, ds)
    nc = states.shape[2]
    assert nc == 5
    perm = (list(reversed(range(nc))) if order == "reversed"
            else [int(i) for i in np.random.RandomState(3).permutation(nc)])
    args = (r, k, v, logw, u, states, do, ends)
    want = ref.chunk_grads(*args)
    got = ref.chunk_grads(*args, order=perm)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _jax_vjp(r, k, v, logw, u, st, do, ds):
    chunk = _chunk(r.shape[1])

    def f(r, k, v, logw, u, st):
        return jax_ssm.rwkv6_chunked(r, k, v, logw, u, state=st,
                                     chunk=chunk)
    args = [jnp.asarray(a) for a in (r, k, v, logw, u, st)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(ds)))]


@pytest.mark.parametrize("B,S,H,K", [(2, 48, 2, 16), (1, 128, 2, 32),
                                     (2, 37, 1, 64), (1, 144, 2, 16),
                                     (2, 63, 2, 16), (1, 64, 2, 32),
                                     (2, 65, 1, 16), (1, 129, 2, 16)])
def test_plain_backward_matches_jax_vjp(B, S, H, K):
    """Against ``jax.vjp`` of the JAX package's chunked form (chunks of up
    to 64, 43 at S = 129; the moderate decay; one u per call, as it
    takes)."""
    r, k, v, logw, u, st, do, ds = _inputs(B * S + K, B, S, H, K, False,
                                           True, 0)
    got = ref.rwkv6_chunked_backward(*(_t(a) for a in (
        r, k, v, logw, u, st, do, ds)))
    _held(got, _jax_vjp(r, k, v, logw, u, st, do, ds), JAX_TOL)


def test_grouped_u_matches_jax_vjp_per_group():
    """u (G, H, K): du of group g is JAX's du over the rows that read it."""
    r, k, v, logw, u, st, do, ds = _inputs(11, 4, 32, 2, 16, False, True, 2)
    got = ref.rwkv6_chunked_backward(*(_t(a) for a in (
        r, k, v, logw, u, st, do, ds)))
    for g in range(2):
        rows = slice(2 * g, 2 * g + 2)
        want = _jax_vjp(*(a[rows] for a in (r, k, v, logw)), u[g],
                        st[rows], do[rows], ds[rows])
        part = [t[rows] for t in got[:4]] + [got[4][g], got[5][rows]]
        _held(part, want, JAX_TOL)


@pytest.mark.parametrize("state", [False, True])
def test_function_on_cpu_equals_plain_backward(state):
    """``RWKV6Chunked`` takes the plain forward and backward on the CPU:
    its gradients are the plain backward's bit for bit, and no kernel
    launches."""
    r, k, v, logw, u, st, do, ds = _inputs(5, 2, 40, 2, 32, False, state, 2)
    xs = [_t(a).requires_grad_() for a in (r, k, v, logw, u)]
    s0 = None if st is None else _t(st).requires_grad_()
    n0 = rwkv6.LAUNCHES, rwkv6_bwd.LAUNCHES
    o, s = ops.RWKV6Chunked.apply(*xs, s0)
    want_o, want_s = ref.rwkv6_chunked(*(_t(a) for a in (
        r, k, v, logw, u, st)))
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(s, want_s, rtol=0, atol=0)
    loss = (o * _t(do)).sum() + (s * _t(ds)).sum()
    grads = torch.autograd.grad(loss, xs + ([] if s0 is None else [s0]))
    want = ref.rwkv6_chunked_backward(*(_t(a) for a in (
        r, k, v, logw, u, st, do, ds)))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (rwkv6.LAUNCHES, rwkv6_bwd.LAUNCHES) == n0


def test_model_path_trains_through_the_function():
    """``ssm.rwkv6_chunked`` under grad, with the cube's PEs folded into
    the batch and one u per PE, gives autograd's gradients; without grad
    it is the plain dispatch (no saved states)."""
    r, k, v, logw, _, _, do, _ = _inputs(6, 8, 32, 2, 16, False, False, 0)
    u = (0.1 * np.random.RandomState(1).standard_normal((4, 2, 16))
         ).astype(np.float32)
    lead = (2, 2, 2)
    xs = [_t(a).reshape(lead + a.shape[1:]).requires_grad_()
          for a in (r, k, v, logw)]
    uu = _t(u).reshape(2, 2, 2, 16).requires_grad_()
    o, _ = ssm.rwkv6_chunked(*xs, uu)
    assert "RWKV6Chunked" in type(o.grad_fn.next_functions[0][0]).__name__
    grads = torch.autograd.grad((o * _t(do).reshape(o.shape)).sum(),
                                xs + [uu])
    ys = [_t(a).requires_grad_() for a in (r, k, v, logw)]
    uy = _t(u).requires_grad_()
    oy, _ = ref.rwkv6_chunked(*ys, uy)
    want = torch.autograd.grad((oy * _t(do)).sum(), ys + [uy])
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.reshape(w.shape), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(w.abs().max())))
    with torch.no_grad():
        o2, _ = ssm.rwkv6_chunked(*xs, uu)
    assert o2.grad_fn is None


def test_launchers_refuse_cpu_tensors_and_grad():
    r, k, v, logw, u, st, do, ds = (_t(a) for a in _inputs(
        2, 1, 16, 2, 16, False, True, 0))
    states = ref.chunk_states(k, v, logw, st)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_bwd.rwkv6_chunked_backward(r, k, v, logw, u, st, do, ds,
                                         states)
    with pytest.raises(RuntimeError, match="requires grad"):
        rwkv6_bwd.rwkv6_chunked_backward(r.requires_grad_(), k, v, logw, u,
                                         st, do, ds, states)
    with pytest.raises(RuntimeError, match="requires grad"):
        rwkv6.rwkv6_chunked(r, k, v, logw, u, st, states=True)


# the card's cases: B, S, H, K, strong decay, state in, u groups. K = 16,
# 32 and 64; lengths 1, 15, 16, 17, 37, 63, 65, 129 and 144 around the
# sub-chunk and the 64-step chunk; the JAX sweep's strong decay; one u per
# folded PE; the training shape
CARD_CASES = [(1, 128, 2, 16, True, False, 0),
              (2, 64, 4, 32, True, True, 0),
              (1, 1, 4, 64, False, True, 0),
              (2, 15, 4, 64, False, True, 2),
              (2, 16, 4, 32, False, True, 0),
              (2, 17, 4, 16, False, True, 2),
              (4, 37, 2, 64, False, True, 4),
              (2, 144, 4, 64, False, True, 0),
              (2, 63, 4, 64, False, True, 0),
              (2, 65, 4, 32, False, True, 2),
              (1, 129, 2, 16, True, True, 0),
              (4, 1024, 64, 64, False, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_on_the_card(dtype):
    """The kernel against the plain backward on the states the forward
    kernel saves every 64 steps, (B, H, ceil(S / 64), K, K) (held to
    ``ref.chunk_states``): f32 within 5e-4 and bf16 within 5e-2 of max(1,
    max|plain|); two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    tol = 5e-4 if dt == torch.float32 else 5e-2
    for case in CARD_CASES:
        *shape, strong, state, G = case
        a = _inputs(7, *shape, strong, state, G)
        r, k, v, logw, u, st, do, ds = (
            None if x is None else torch.from_numpy(x).to(dev) for x in a)
        r, k, v, u, do = (x.to(dt) for x in (r, k, v, u, do))
        _, _, states = rwkv6.rwkv6_chunked(r, k, v, logw, u, st,
                                           states=True)
        want_states = ref.chunk_states(k, v, logw, st)
        assert states.shape == (shape[0], shape[2], -(-shape[1] // 64),
                                shape[3], shape[3])
        args = (r, k, v, logw, u, st, do, ds if state else None)
        got = rwkv6_bwd.rwkv6_chunked_backward(*args, states)
        again = rwkv6_bwd.rwkv6_chunked_backward(*args, states)
        want = ref.rwkv6_chunked_backward(*args, want_states)
        torch.cuda.synchronize()
        assert float((states - want_states).abs().max()) <= 1e-5 * max(
            1.0, float(want_states.abs().max()))
        for name, g, w, g2 in zip(NAMES, got, want, again):
            if w is None:
                assert g is None
                continue
            assert torch.equal(g, g2), (case, name)
            err = float((g.float() - w.float()).abs().max())
            assert err <= tol * max(1.0, float(w.float().abs().max())), (
                case, name, err)
