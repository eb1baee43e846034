"""The flash-attention backward on the CPU: ``ref.flash_attention_backward``
(the plain version of ``csrc/flash_bwd.cu``) against autograd of
``ref.flash_attention`` (1e-6) and against ``jax.vjp`` of the JAX
package's ``layers.chunked_attention`` (1e-5), both x max(1, max|ref|), over
causal / full / windowed masks, offsets, GQA and rows that see no key;
``ops.FlashAttention`` carrying gradients when its forward is a detached
launch (a stand-in for the kernel, whose outputs have no ``grad_fn``); and
the launchers' guard: each kernel wrapper raises under grad. The kernel
itself runs only on the card (``cuda`` marker)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention as jax_chunked

from repro_torch.kernels.attention import flash, flash_bwd, ops, ref
from repro_torch.kernels.reorder import reorder
from repro_torch.kernels.rwkv6 import rwkv6
from repro_torch.models import layers

AUTOGRAD_TOL = 1e-6
JAX_TOL = 1e-5

# B, Sq, Sk, H, KV, hd, causal, window, q0, k0
CASES = {
    "causal": (2, 12, 12, 4, 2, 16, True, -1, 0, 0),
    "causal_gqa8": (1, 9, 9, 8, 1, 16, True, -1, 0, 0),
    "full": (2, 7, 11, 4, 4, 8, False, -1, 0, 0),
    "window": (2, 16, 16, 4, 2, 16, True, 5, 0, 0),
    "window_offsets": (1, 10, 14, 4, 2, 16, True, 6, 8, 4),
    "decode_rows": (2, 2, 20, 4, 2, 16, True, -1, 19, 0),
    "rows_without_key": (2, 8, 10, 4, 2, 16, True, -1, 0, 4),
    "window_without_key": (1, 6, 12, 2, 1, 16, True, 2, 0, 8),
    # phi3-mini's head dim (G = 1) and gemma3's (one kv head, G = 4, a
    # local window)
    "hd96_causal": (2, 12, 12, 4, 4, 96, True, -1, 0, 0),
    "hd96_window_offsets": (1, 10, 14, 4, 2, 96, True, 6, 8, 4),
    "hd256_causal_gqa4": (1, 9, 9, 4, 1, 256, True, -1, 0, 0),
    "hd256_window_gqa4": (2, 16, 16, 4, 1, 256, True, 5, 0, 0),
    "hd256_rows_without_key": (1, 8, 10, 4, 1, 256, True, -1, 0, 4),
}


def _inputs(case, seed=0):
    B, Sq, Sk, H, KV, hd, causal, window, q0, k0 = CASES[case]
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
                      (B, Sq, H, hd))]
    q_pos = (q0 + torch.arange(Sq)).expand(B, Sq).to(torch.int32)
    k_pos = (k0 + torch.arange(Sk)).expand(B, Sk).to(torch.int32)
    return arrs, q_pos.contiguous(), k_pos.contiguous(), causal, window


def _bound(ref_arr, tol):
    return tol * max(1.0, float(np.abs(ref_arr).max()))


def _autograd_of_ref(arrs, q_pos, k_pos, causal, window):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    do = torch.from_numpy(arrs[3])
    out = ref.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                              window=window)
    return torch.autograd.grad(out, (q, k, v), do)


def _plain_backward(arrs, q_pos, k_pos, causal, window):
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, m, l = ref.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                  window=window, stats=True)
    return ref.flash_attention_backward(q, k, v, o, m, l, do, q_pos, k_pos,
                                        causal=causal, window=window)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_of_ref(case):
    arrs, q_pos, k_pos, causal, window = _inputs(case)
    want = _autograd_of_ref(arrs, q_pos, k_pos, causal, window)
    got = _plain_backward(arrs, q_pos, k_pos, causal, window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float((g - w).abs().max()) <= _bound(w.numpy(), AUTOGRAD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case):
    arrs, q_pos, k_pos, causal, window = _inputs(case, seed=1)
    B, Sq, Sk, H, KV, hd, causal, window, q0, k0 = CASES[case]
    q, k, v, do = (jnp.asarray(a) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jax_chunked(
        q, k, v, causal=causal, window=window, q_offset=q0, k_offset=k0),
        q, k, v)
    want = [np.asarray(x) for x in vjp(do)]
    got = _plain_backward(arrs, q_pos, k_pos, causal, window)
    for g, w in zip(got, want):
        assert float(np.abs(g.numpy() - w).max()) <= _bound(w, JAX_TOL)


def test_rows_without_key_give_dv_the_mean_of_do():
    """A row that sees no key has p = 1 / Sk over every key: its do is
    spread evenly into dv, and it puts nothing into dq or dk."""
    arrs, q_pos, k_pos, causal, window = _inputs("rows_without_key")
    B, Sq, Sk, H, KV, hd = CASES["rows_without_key"][:6]
    dead = (q_pos < k_pos[:, :1])                   # (B, Sq): q < first key
    assert bool(dead.any())
    keep = [a.copy() for a in arrs]
    keep[3][~dead.numpy()] = 0.0                    # do only on dead rows
    dq, dk, dv = _plain_backward(keep, q_pos, k_pos, causal, window)
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    do = torch.from_numpy(keep[3]).reshape(B, Sq, KV, H // KV, hd)
    want = do.sum(dim=(1, 3)) / Sk                  # (B, KV, hd)
    assert torch.allclose(dv, want[:, None].expand_as(dv), atol=1e-6)


@pytest.mark.parametrize("case", ["causal", "window_offsets",
                                  "rows_without_key"])
def test_flash_attention_function_carries_gradients(monkeypatch, case):
    """With its forward replaced by a detached launch of the plain version
    under no_grad -- outputs without grad_fn, as the kernel writes them --
    ``FlashAttention`` still gives autograd-of-ref gradients: they come
    from its backward, not from the forward's graph."""
    arrs, q_pos, k_pos, causal, window = _inputs(case, seed=2)
    plain = ref.flash_attention
    calls = []

    def launch(*args, **kw):
        with torch.no_grad():
            res = plain(*args, **kw)
        calls.append(kw)
        return tuple(t.detach() for t in res)

    monkeypatch.setattr(ops, "_forward", lambda q: launch)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    out = ops.FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window)
    assert out.grad_fn is not None and calls == [
        {"causal": causal, "window": window, "stats": True, "lowp": 0}]
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrs[3]))
    want = _autograd_of_ref(arrs, q_pos, k_pos, causal, window)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= _bound(w.numpy(), AUTOGRAD_TOL)


def test_chunked_attention_trains_through_flash_attention(monkeypatch):
    """Under grad the model's attention goes through ``FlashAttention``
    (the partial form through ``FlashAttentionPartial``); without grad it
    takes the plain dispatch (bit-identical outputs)."""
    arrs, q_pos, k_pos, causal, window = _inputs("causal")
    seen = []
    real = ops.FlashAttention.apply
    monkeypatch.setattr(ops.FlashAttention, "apply",
                        lambda *a: seen.append(1) or real(*a))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    out = layers.chunked_attention(q, k, v, causal=True)
    assert seen == [1] and out.grad_fn is not None
    with torch.no_grad():
        again = layers.chunked_attention(q, k, v, causal=True)
    assert seen == [1] and torch.equal(out.detach(), again)
    part = []
    real_p = ops.FlashAttentionPartial.apply
    monkeypatch.setattr(ops.FlashAttentionPartial, "apply",
                        lambda *a: part.append(1) or real_p(*a))
    acc, m, l = layers.chunked_attention(q, k, v, causal=True, partial=True)
    assert part == [1] and acc.grad_fn is not None and l.grad_fn is not None
    with torch.no_grad():
        again = layers.chunked_attention(q, k, v, causal=True, partial=True)
    assert part == [1] and all(torch.equal(a.detach(), b)
                               for a, b in zip((acc, m, l), again))


def test_launchers_raise_under_grad():
    """No kernel can drop a gradient without an error: each wrapper raises
    when grad mode is on and an input requires grad (before it looks at
    the device), and not under no_grad."""
    q = torch.zeros(1, 2, 2, 16, requires_grad=True)
    pos = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash.flash_attention(q, q, q, pos, pos)
    o = torch.zeros(1, 2, 2, 128)
    st = torch.zeros(1, 2, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_bwd.flash_attention_backward(
            q, q, q, o, st, st, o, pos, pos)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_bwd.flash_attention_partial_backward(
            q, q, q, st, o, st, pos, pos)
    x = torch.zeros(8, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        reorder.tile_swizzle(x, [1, 0])
    r = torch.zeros(1, 4, 1, 16, requires_grad=True)
    u = torch.zeros(1, 16)
    with pytest.raises(RuntimeError, match="requires grad"):
        rwkv6.rwkv6_chunked(r, r, r, r.detach(), u)
    with torch.no_grad():                  # the guard passes; the device not
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_attention(q, q, q, pos, pos)
        with pytest.raises(ValueError, match="CUDA"):
            reorder.tile_swizzle(x, [1, 0])


def test_backward_layout_checks():
    """The kernel takes every head dim of the forward (the "causal" case's
    16) and refuses one outside them (the "full" case's 8)."""
    for case, ok in (("causal", True), ("full", False)):
        arrs, q_pos, k_pos, causal, window = _inputs(case)
        q, k, v, do = (torch.from_numpy(a) for a in arrs)
        o, m, l = (t.contiguous() for t in ref.flash_attention(
            q, k, v, q_pos, k_pos, stats=True))
        if ok:
            assert flash_bwd.check_layout(q, k, v, o, m, l, do, q_pos,
                                          k_pos).dq.form == "f32"
            continue
        with pytest.raises(ValueError, match="head_dim"):
            flash_bwd.check_layout(q, k, v, o, m, l, do, q_pos, k_pos)


# B, Sq, Sk, H, KV, q0: off the tiles, the 1-PE training shape (4 x 1,024
# causal tokens, 16 / 8 heads), and G * Sq and Sk off the bf16 passes'
# 4-warp (2 x 200 x 8 / 4) and 8-warp (16 x 300 x 8 / 4) CTA tiles
CARD_SHAPES = {"offsets": (2, 100, 130, 8, 2, 30),
               "train_1pe": (4, 1024, 1024, 16, 8, 0),
               "ragged_4warp": (2, 200, 333, 8, 4, 0),
               "ragged_8warp": (16, 300, 300, 8, 4, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", flash_bwd.HEAD_DIMS)
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_version_on_the_card(dtype, shape, hd):
    """At every head dim: each of dq, dk and dv within 1e-4 (f32) / 5e-2
    (bf16) of its own max|plain|; two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, Sq, Sk, H, KV, q0 = CARD_SHAPES[shape]
    q, do = (torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, KV, hd, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    q_pos = (torch.arange(Sq, device="cuda") + q0).expand(B, Sq)
    k_pos = torch.arange(Sk, device="cuda").expand(B, Sk)
    q_pos, k_pos = (p.to(torch.int32).contiguous() for p in (q_pos, k_pos))
    o, m, l = flash.flash_attention(q, k, v, q_pos, k_pos, stats=True)
    got = flash_bwd.flash_attention_backward(q, k, v, o, m, l, do, q_pos,
                                             k_pos)
    again = flash_bwd.flash_attention_backward(q, k, v, o, m, l, do, q_pos,
                                               k_pos)
    want = ref.flash_attention_backward(q, k, v, o, m, l, do, q_pos, k_pos)
    tol = {"float32": 1e-4, "bfloat16": 5e-2}[dtype]
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert float((g.float() - w.float()).abs().max()) <= tol * float(
            w.float().abs().max())


def test_partial_backward_refuses_by_name():
    """The partial backward's wrapper checks its cotangents' types and
    shapes and the layout (``check_layout``) before it looks at the device,
    naming itself: f32 m, dacc (B, H, Sq, hd) and dl (B, H, Sq), a head
    dim the kernel takes, one CUDA device."""
    name = "flash_attention_partial_backward"
    B, S, H, KV, hd = 1, 4, 2, 1, 16
    q, k = torch.zeros(B, S, H, hd), torch.zeros(B, S, KV, hd)
    st, dacc = torch.zeros(B, H, S), torch.zeros(B, H, S, hd)
    pos = torch.zeros(B, S, dtype=torch.int32)
    fn = flash_bwd.flash_attention_partial_backward
    with pytest.raises(ValueError, match=f"{name}: dacc must be f32"):
        fn(q, k, k, st, dacc[..., :8], st, pos, pos)
    with pytest.raises(ValueError, match=f"{name}: dl must be f32"):
        fn(q, k, k, st, dacc, st.double(), pos, pos)
    with pytest.raises(ValueError, match=f"{name}: q must be"):
        fn(q[0], k, k, st, dacc, st, pos, pos)
    with pytest.raises(ValueError, match=f"{name}: every tensor"):
        fn(q, k, k, st, dacc, st, pos, pos)
    bad = torch.zeros(B, S, H, 48)
    with pytest.raises(ValueError, match=f"{name} kernel takes head_dim"):
        flash_bwd.check_layout(bad, torch.zeros(B, S, KV, 48),
                               torch.zeros(B, S, KV, 48), bad, st, st, bad,
                               pos, pos, name=name)
    with pytest.raises(TypeError, match=f"{name}: m and l must be f32"):
        flash_bwd.check_layout(q, k, k, q, st.double(), st, q, pos, pos,
                               name=name)
