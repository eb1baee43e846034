"""The port's low-precision modes (``LOWP`` 1 / 2) held against the JAX
package on the CPU.

The reference's ``repro.models.layers.LOWP`` is set by ``monkeypatch``, the
port's ``repro_torch.models.layers.LOWP`` likewise (``chunked_attention``
takes the mode as its ``lowp`` argument). On NumPy-seeded bf16 inputs:
``rms_norm`` at modes 0 / 1 / 2; ``chunked_attention`` at modes 0 / 1 / 2
-- full and partial, causal and not, windowed (the reference's banded path
too, over several query blocks), G 1 and 4, with offsets, rows that see
no key -- within ``ATTN_TOL`` of max|JAX|, their f32 partials within
``PARTIAL_TOL``; the gradients of attention under modes 1 / 2 (the plain
backward, which keeps its f32 recompute) against ``jax.grad`` of the
reference's low-precision forward, within ``GRAD_TOL`` of each gradient's
own max; decode's attention, which takes no mode; f32 inputs, which the
modes leave alone. The model level is ``tests/test_torch_lowp_models.py``.

The two packages round the same bf16 products apart where an f32 sum
lands next to a bf16 rounding boundary, and the reference's scan over key
chunks rescales bf16 probabilities by an f32 correction where the port's
single pass does not: the tolerances say how far that goes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers

from repro_torch import configs
from repro_torch.kernels.attention import ops, ref
from repro_torch.models import layers
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology

ATTN_TOL = 8e-3       # x max|JAX|: a bf16 ulp (2^-8) of the largest output
GRAD_TOL = 5e-2       # x each gradient's own max: the bf16 backward's gate
# the f32 partials (acc, m, l) x max|JAX| where the reference runs one key
# chunk: f32 sum order in modes 0 and 1; in mode 2 a bf16 score rounded
# apart (an ulp of m moves every p; 1.1e-3 read). Over several chunks the
# reference rounds p against each chunk's running max and rescales it in
# f32, where the port's single pass rounds it against the row's: up to
# 2.0e-3 read in modes 1 and 2 (CHUNKED_TOL)
PARTIAL_TOL = {0: 1e-5, 1: 1e-5, 2: 1.5e-3}
CHUNKED_TOL = 2.5e-3
CPU = torch.device("cpu")
MODES = (0, 1, 2)


@pytest.fixture
def lowp(monkeypatch):
    """Set both packages' mode for one test: ``lowp(mode)``."""
    def set_mode(mode):
        monkeypatch.setattr(jax_layers, "LOWP", mode)
        monkeypatch.setattr(layers, "LOWP", mode)
    return set_mode


def _bf16(rng, shape, scale=1.0):
    """NumPy-seeded values rounded to bf16: the JAX array and the port's
    tensor hold the same bits."""
    x = jnp.asarray(scale * rng.standard_normal(shape), jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------- rms_norm
@pytest.mark.parametrize("mode", MODES)
def test_rms_norm_matches_jax(lowp, mode):
    lowp(mode)
    rng = np.random.default_rng(mode)
    jx, tx = _bf16(rng, (3, 7, 64), 2.0)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jax_layers.rms_norm(jx, jnp.asarray(scale))
    got = layers.rms_norm(tx, torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got, want) <= ATTN_TOL
    if mode:   # the (.., D) tensor is x * bf16(r): a bf16 product
        lowp(0)
        plain = layers.rms_norm(tx, torch.from_numpy(scale))
        assert not torch.equal(plain, got)


# -------------------------------------------------------------- attention
# B, Sq, Sk, H, KV, hd, causal, window, q_offset, k_offset, partial, chunk
ATTN_CASES = {
    "causal_g2": (2, 16, 16, 4, 2, 32, True, -1, 0, 0, False, 1024),
    "causal_g1_chunks": (1, 48, 48, 4, 4, 16, True, -1, 0, 0, False, 16),
    "full_g4": (2, 12, 20, 8, 2, 32, False, -1, 0, 0, False, 1024),
    "window_offsets_g4": (2, 8, 40, 8, 2, 16, True, 7, 32, 0, False, 1024),
    "banded_blocks": (1, 64, 64, 4, 1, 32, True, 12, 0, 0, False, 16),
    "partial_g1": (2, 4, 40, 2, 2, 32, True, -1, 36, 0, True, 1024),
    "partial_g4_window": (1, 6, 30, 8, 2, 16, True, 9, 24, 0, True, 1024),
    # rows 0-7 see no key (keys from position 8)
    "no_key_rows": (1, 16, 16, 4, 2, 16, True, -1, 0, 8, False, 1024),
    "no_key_rows_partial": (1, 16, 16, 4, 2, 16, True, -1, 0, 8, True,
                            1024),
}


def _attn_inputs(case, seed):
    B, Sq, Sk, H, KV, hd = ATTN_CASES[case][:6]
    rng = np.random.default_rng(seed)
    return [_bf16(rng, s) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                    (B, Sk, KV, hd))]


def _partials_err(got, want) -> float:
    """The largest error of the port's f32 partials (acc, m, l) over each
    one's max|JAX|, m on the rows that see a key; rows that see none must
    hold m = -1e30 in both. The reference's (B, KV, G, Sq, ...) partials
    are the port's (B, H, Sq, ...): head h = kv head h // G, member h % G."""
    errs = []
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(g.shape)
        live = w > -1e29 if w.ndim == 3 else np.ones(w.shape, bool)
        errs.append(_rel(g[torch.from_numpy(live)], w[live]))
    m, wm = got[1].numpy(), np.asarray(want[1]).reshape(got[1].shape)
    assert (m[wm <= -1e29] == -1e30).all() and (wm[m <= -1e29] <= -1e29).all()
    return max(errs)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_jax(lowp, case, mode):
    """The case's form (output in bf16, or the f32 partials) within
    ATTN_TOL, and the f32 partials of every case within PARTIAL_TOL of the
    mode: the bf16 output's rounding hides which mode ran, the partials
    do not (a mode-2 forward held to mode 0 reads 1.7e-3 - 7e-3 on them,
    a mode-1 one 7e-4 - 4e-3, at one chunk)."""
    B, Sq, Sk, H, KV, hd, causal, window, qo, ko, partial, chunk = \
        ATTN_CASES[case]
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(case, 7)
    lowp(mode)
    kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko)
    want = jax_layers.chunked_attention(jq, jk, jv, chunk=chunk,
                                        partial=partial, **kw)
    got = layers.chunked_attention(tq, tk, tv, partial=partial, lowp=mode,
                                   **kw)
    if partial:
        assert _partials_err(got, want) <= ATTN_TOL
    else:
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= ATTN_TOL
        want = jax_layers.chunked_attention(jq, jk, jv, chunk=chunk,
                                            partial=True, **kw)
        got = layers.chunked_attention(tq, tk, tv, partial=True, lowp=mode,
                                       **kw)
    tol = PARTIAL_TOL[mode] if chunk >= Sk or not mode else CHUNKED_TOL
    assert _partials_err(got, want) <= tol


# the row-statistics limits of chip_smoke.py (LOWP_STAT_TOL, LOWP_P_TOL):
# the kernel's m and l lie within them of the plain version in its mode
STAT_TOL = {1: {"m": 1e-5, "l": 1e-4}, 2: {"m": 1e-5, "l": 1e-3}}
P_TOL = 1e-5


def _row_stat_means(a, b) -> dict:
    """Means over the rows that see a key of |m_a - m_b| / max(1, |m_b|)
    and |l_a - l_b| / l_b, of two partials (acc, m, l)."""
    live = b[1] > -1e29
    m, l, mb, lb = a[1][live], a[2][live], b[1][live], b[2][live]
    return {"m": float(((m - mb).abs() / mb.abs().clamp_min(1)).mean()),
            "l": float(((l - lb).abs() / lb).mean())}


@pytest.mark.parametrize("mode", (1, 2))
def test_row_statistics_tell_the_mode_from_the_one_below(mode):
    """chip_smoke.py holds the kernel's row statistics in mode 1 / 2 to the
    plain version's within STAT_TOL, and needs the plain version in the
    mode below to fall outside it: mode 1 scales q in bf16 (at hd 128 the
    scale is no power of two, so m moves), mode 2 rounds the scores and p
    to bf16. Here the plain versions of the two modes, at hd 128."""
    rng = np.random.default_rng(9)
    q, k, v = (_bf16(rng, s)[1] for s in ((2, 40, 8, 128), (2, 96, 2, 128),
                                          (2, 96, 2, 128)))
    q_pos = (56 + torch.arange(40, dtype=torch.int32)).expand(2, -1)
    k_pos = torch.arange(96, dtype=torch.int32).expand(2, -1)
    kw = dict(causal=True, window=-1, partial=True)
    this = ref.flash_attention(q, k, v, q_pos, k_pos, lowp=mode, **kw)
    below = ref.flash_attention(q, k, v, q_pos, k_pos, lowp=mode - 1, **kw)
    assert _row_stat_means(this, this) == {"m": 0.0, "l": 0.0}
    apart = _row_stat_means(this, below)
    assert all(apart[s] > STAT_TOL[mode][s] for s in ("m", "l")), apart


@pytest.mark.parametrize("mode", (1, 2))
def test_mode2_rounds_p_before_both_sums(mode):
    """On v = 1 a partial's acc[..., 0] sums the p that l sums. Mode 2
    rounds p to bf16 before both sums, so they agree to f32 order; mode 1
    rounds it for p v alone, so they part by more than P_TOL (the control
    of chip_smoke.py's check of the kernel's mode-2 p)."""
    rng = np.random.default_rng(10)
    q, k = (_bf16(rng, s)[1] for s in ((2, 24, 4, 32), (2, 70, 2, 32)))
    v = torch.ones((2, 70, 2, 32), dtype=torch.bfloat16)
    q_pos = (40 + torch.arange(24, dtype=torch.int32)).expand(2, -1)
    k_pos = torch.arange(70, dtype=torch.int32).expand(2, -1)
    acc, m, l = ref.flash_attention(q, k, v, q_pos, k_pos, partial=True,
                                    lowp=mode)
    dev = float(((acc[..., 0] - l).abs() / l)[m > -1e29].mean())
    assert dev <= 1e-6 if mode == 2 else dev > P_TOL


def test_f32_inputs_ignore_the_mode(lowp):
    """On f32 q the reference computes the mode-0 function under every mode;
    so does the port, bit for bit."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 8, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    scale = torch.from_numpy((0.1 * rng.standard_normal(32))
                             .astype(np.float32))
    outs = []
    for mode in MODES:
        lowp(mode)
        outs.append((layers.rms_norm(x, scale),
                     layers.chunked_attention(q, k, v, q_offset=4,
                                              lowp=mode)))
    for a, b in outs[1:]:
        assert torch.equal(a, outs[0][0]) and torch.equal(b, outs[0][1])


def test_int8_cache_refuses_a_mode():
    q = torch.zeros((1, 1, 2, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 2, 16), dtype=torch.int8)
    s = torch.ones((1, 4, 2))
    pos = torch.zeros((1, 1), dtype=torch.int32)
    kpos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="low-precision"):
        ops.flash_attention(q, k, k, pos, kpos, partial=True, k_scale=s,
                            v_scale=s, lowp=2)


# ------------------------------------------------------------- gradients
GRAD_CASES = ("causal_g2", "window_offsets_g4", "full_g4", "no_key_rows")


@pytest.mark.parametrize("mode", (1, 2))
@pytest.mark.parametrize("case", GRAD_CASES)
def test_attention_grads_match_jax_grad(lowp, case, mode):
    """``FlashAttention`` under a mode: its forward is the low-precision
    form, its backward the plain f32 recompute from the forward's row
    statistics. Held to ``jax.grad`` of the reference's low-precision
    ``chunked_attention`` (bf16 in, bf16 cotangents out)."""
    B, Sq, Sk, H, KV, hd, causal, window, qo, ko, _, chunk = \
        ATTN_CASES[case]
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(case, 11)
    jdo, tdo = _bf16(np.random.default_rng(12), (B, Sq, H, hd))
    lowp(mode)

    def loss(q, k, v):
        o = jax_layers.chunked_attention(
            q, k, v, causal=causal, window=window, q_offset=qo, k_offset=ko,
            chunk=chunk)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = layers.chunked_attention(*leaves, causal=causal, window=window,
                                   q_offset=qo, k_offset=ko, lowp=mode)
    got = torch.autograd.grad(out, leaves, tdo)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g, w) <= GRAD_TOL


def test_flash_attention_passes_the_mode_to_its_forward(monkeypatch):
    """The training Function hands the mode to the forward, mode 0
    included."""
    calls = []
    plain = ref.flash_attention

    def recording(*args, **kw):
        calls.append(kw.get("lowp"))
        return plain(*args, **kw)

    monkeypatch.setattr(ops, "_forward", lambda q: recording)
    (_, tq), (_, tk), (_, tv) = _attn_inputs("causal_g2", 1)
    for mode in MODES:
        layers.chunked_attention(tq.requires_grad_(), tk, tv, lowp=mode)
    assert calls == [0, 1, 2]


def test_decode_attention_takes_no_mode(lowp, monkeypatch):
    """The reference's decode computes its own f32 scores, whatever LOWP
    is: the port's decode passes mode 0, so under LOWP 2 each decode
    attention call takes no mode and gives the mode-0 bits of its inputs
    (the inputs themselves move with ``rms_norm``, which the mode does
    reach)."""
    cfg = configs.get("qwen3-1.7b").scaled_for_smoke()
    topo = build_serve_topology(cfg, 2)
    plan = make_serve_plan(cfg, topo, S_ctx=8, global_batch=2)
    server = Server(cfg, topo, plan)
    from repro_torch.models.params import init_params
    params = init_params(cfg, topo, 0, device=CPU)
    cache = init_cache(cfg, topo, plan, device=CPU)
    seen = []
    plain = ops.flash_attention

    def recording(*args, **kw):
        res = plain(*args, **kw)
        seen.append((args, kw, res))
        return res

    monkeypatch.setattr(ops, "flash_attention", recording)
    lowp(2)
    tok = topo.cube.to_cube(torch.tensor([3, 5]), (None,))
    for t in range(3):
        pos = topo.cube.to_cube(torch.tensor([t, t]), (None,))
        server.decode_shard(params, cache, tok, pos)
    assert len(seen) == 3 * cfg.n_layers
    for args, kw, res in seen:
        assert kw.get("lowp", 0) == 0
        again = ref.flash_attention(*args, causal=kw["causal"],
                                    window=kw["window"], partial=True)
        assert all(torch.equal(a, b) for a, b in zip(res, again))
