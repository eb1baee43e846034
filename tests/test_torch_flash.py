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
    (1, 128, 4, 4, 96),     # MHA at phi3-mini's head_dim
    (2, 128, 8, 2, 96),     # GQA 4:1 at head_dim 96
    (1, 128, 4, 1, 256),    # MQA (G = 4) at gemma3's head_dim
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
    (1, 128, 4, 4, 96),     # MHA, head_dim 96
    (1, 128, 4, 1, 256),    # MQA, head_dim 256
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


# (B, Sq, Sk, H, KV, hd): every main-path row of chip_smoke.py (qwen3 and
# MoE decode and forward at 1 and 8 PEs; phi3-mini at 1 and 8, gemma3 at 1
# and 4 PEs, and gemma3's 1,024-token forward; internlm2 (G = 6) at 1 and 16
# PEs; whisper-base's decode, cross decode and forward at 1 and 8 PEs), its
# two long rows, ragged edges
GEOMETRY_SHAPES = [
    (4, 1, 48, 16, 8, 128), (32, 1, 6, 16, 8, 128), (4, 1, 48, 16, 16, 128),
    (32, 1, 6, 16, 16, 128), (4, 48, 48, 16, 8, 128), (32, 48, 48, 2, 1, 128),
    (4, 1, 4096, 16, 8, 128), (4, 2048, 2048, 16, 8, 128),
    (2, 37, 70, 8, 1, 32), (3, 16, 16, 4, 2, 16), (1, 33, 33, 4, 4, 64),
    (2, 3, 600, 4, 2, 64), (1, 1, 513, 2, 1, 16), (2, 5, 9, 16, 16, 32),
    (1, 9, 65, 8, 8, 128), (1, 1, 1031, 8, 1, 128),
    (4, 1, 48, 32, 32, 96), (32, 1, 6, 32, 32, 96), (4, 48, 48, 32, 32, 96),
    (32, 48, 48, 4, 4, 96), (4, 1, 48, 4, 1, 256), (16, 1, 12, 4, 1, 256),
    (4, 48, 48, 4, 1, 256), (16, 48, 48, 1, 1, 256),
    (1, 1024, 1024, 4, 1, 256), (2, 2, 600, 8, 2, 256), (1, 8, 70, 2, 2, 96),
    (2, 37, 70, 4, 4, 96), (1, 1, 4096, 4, 1, 256),
    (4, 1, 48, 48, 8, 128), (64, 1, 3, 48, 8, 128), (4, 48, 48, 48, 8, 128),
    (64, 48, 48, 3, 1, 128), (4, 1, 48, 8, 8, 64), (32, 1, 6, 8, 8, 64),
    (4, 48, 48, 8, 8, 64), (32, 48, 48, 1, 1, 64),
]


def _add_block(count, b, heads, pos, keys):
    """count[b, heads[i], pos[i], keys[j]] += 1 for every row i and key j
    of one CTA, a row or key listed twice counted twice."""
    rows, r_times = np.unique(np.stack([heads, pos]), axis=1,
                              return_counts=True)
    ks, k_times = np.unique(keys, return_counts=True)
    count[b, rows[0][:, None], rows[1][:, None], ks[None, :]] += \
        r_times[:, None] * k_times[None, :]


def _coverage(geo, B, Sq, Sk, H, KV, dtype):
    """How often each (batch, query head, query position, key) is scored
    by the launch ``geo`` describes: CTAs, their warps, lane groups."""
    G = H // KV
    R = Sq * G
    count = np.zeros((B, H, Sq, Sk), np.int64)
    assert geo.grid[0] == B * KV
    warps = geo.block // 32
    for x in range(geo.grid[0]):
        b, kvh = divmod(x, KV)
        for y in range(geo.grid[1]):
            if geo.form == "decode":
                rows = np.arange(R)
                lo = y * geo.keys_per_split
                hi = min(Sk, lo + geo.keys_per_split)
                kpw = geo.key_tile // warps      # lane groups per warp
                keys = np.concatenate(
                    [np.arange(lo + w * kpw + g, hi, geo.key_tile)
                     for w in range(warps) for g in range(kpw)])
            else:
                per_warp = geo.row_tile // warps
                rows = y * geo.row_tile + (
                    np.arange(warps)[:, None] * per_warp
                    + np.arange(per_warp)).ravel()
                rows = rows[rows < R]
                keys = (np.arange(0, Sk, geo.key_tile)[:, None]
                        + np.arange(geo.key_tile)).ravel()
                keys = keys[keys < Sk]
            if len(rows) and len(keys):
                _add_block(count, b, kvh * G + rows % G, rows // G, keys)
    return count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", GEOMETRY_SHAPES)
def test_launch_geometry_covers_every_pair_once(dtype, B, Sq, Sk, H, KV, hd):
    geo = flash.launch_geometry(B, Sq, Sk, H, KV, hd, dtype)
    rows = Sq * H // KV
    assert geo.form == ("decode" if rows <= flash.DECODE_ROWS
                        else "forward")
    assert geo.grid[1] <= flash._MAX_ROW_TILES
    if geo.form == "decode":
        assert geo.row_tile == rows and geo.block == 256
        assert 1 <= geo.key_splits <= flash.MAX_SPLITS
        assert geo.grid[1] == geo.key_splits
        # every split of the cluster has keys
        assert (geo.key_splits - 1) * geo.keys_per_split < Sk
        # lanes holding one key: its 16-byte pieces, rounded up to a power
        # of two, at most a warp (f32 hd 256: two pieces a lane)
        pieces = hd * dtype.itemsize // 16
        lanes = min(32, 1 << (pieces - 1).bit_length())
        assert flash.decode_lanes(hd, dtype) == lanes
        assert geo.key_tile == 32 // lanes * flash.DECODE_WARPS
    else:
        assert geo.key_splits == 1 and geo.keys_per_split == Sk
        if dtype == torch.bfloat16:
            assert geo.row_tile in (16, 32, 64)
            assert geo.block == 2 * geo.row_tile
        else:
            assert geo.row_tile == 32 and geo.block == 256
    count = _coverage(geo, B, Sq, Sk, H, KV, dtype)
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("shape,form,ctas", [
    ((4, 1, 48, 16, 8), "decode", 32),         # qwen3 decode, 1 PE
    ((32, 1, 6, 16, 8), "decode", 256),        # qwen3 decode, 8 PEs
    ((4, 1, 48, 16, 16), "decode", 64),        # MoE decode, 1 PE
    ((32, 1, 6, 16, 16), "decode", 512),       # MoE decode, 8 PEs
    ((4, 48, 48, 16, 8), "forward", 192),      # qwen3 forward, 1 PE
    ((32, 48, 48, 2, 1), "forward", 192),      # qwen3 forward, 8 PEs
    ((4, 1, 4096, 16, 8), "decode", 256),      # long cache: 8-CTA clusters
    ((4, 2048, 2048, 16, 8), "forward", 2048),
])
def test_serving_shapes_fill_the_card(shape, form, ctas):
    """The bf16 main-path forward launches at least one CTA per SM (96
    rows per kv head: 16-row tiles), the long cache splits its keys."""
    geo = flash.launch_geometry(*shape, 128, torch.bfloat16)
    assert geo.form == form
    assert geo.grid[0] * geo.grid[1] == ctas
    if form == "forward" or shape[2] > 1000:
        assert ctas >= flash.SMS


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_raises_on_misaligned_tensor(which, dtype):
    """16-byte vector loads need 16-byte aligned bases: a view that starts
    one element in is refused, never taken by a fallback."""
    B, Sq, Sk, H, KV, hd = 1, 2, 8, 4, 2, 16
    shapes = {"q": (B, Sq, H, hd), "k": (B, Sk, KV, hd), "v": (B, Sk, KV, hd)}
    ts = {n: torch.zeros(s, dtype=dtype) for n, s in shapes.items()}
    q_pos = torch.zeros((B, Sq), dtype=torch.int32)
    k_pos = torch.zeros((B, Sk), dtype=torch.int32)
    args = lambda: (ts["q"], ts["k"], ts["v"], q_pos, k_pos)  # noqa: E731
    assert flash._check_layout(*args()).form == "decode"
    n = int(np.prod(shapes[which]))
    ts[which] = torch.zeros(n + 1, dtype=dtype)[1:].view(shapes[which])
    assert ts[which].is_contiguous() and ts[which].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        flash._check_layout(*args())


# ------------------------------------------------ the strided lead (decode)
def _unit_view(dtype, cube=(2, 4), units=3, u=1, B=2, S=24, KV=2, hd=32,
               seed=5):
    """One unit's view of a cube cache ``(*cube, units, B, S, KV, hd)``,
    as ``Server.decode_shard`` selects it: (*cube, B, S, KV, hd), not
    contiguous, its (S, KV, hd) tail dense."""
    g = torch.Generator().manual_seed(seed)
    full = torch.randn(cube + (units, B, S, KV, hd), generator=g)
    if dtype == torch.int8:
        return torch.randint(-127, 128, full.shape, generator=g,
                             dtype=torch.int8).select(len(cube), u)
    return full.to(dtype).select(len(cube), u)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("partial", [False, True])
def test_plain_version_on_a_unit_view_equals_a_contiguous_copy(dtype,
                                                               partial):
    """Decode hands the flash decode form one unit's slice of the cube
    cache as it lies (``layers._decode_lead``: (C, B_l, S, KV, hd) over the
    flattened cube axes); the plain version reads that view to the same
    bits as a contiguous copy of it, int8 codes with their scales too."""
    cube, B, S, H, KV, hd = (2, 4), 2, 24, 8, 2, 32
    k, v = _unit_view(dtype, seed=5), _unit_view(dtype, seed=6)
    assert not k.is_contiguous()
    scales = {}
    if dtype == torch.int8:
        ks, vs = ((torch.rand(cube + (3, B, S, KV)) + 0.01).select(2, 1)
                  for _ in range(2))
        scales = {"k_scale": ks, "v_scale": vs}
    qdt = torch.float32 if dtype == torch.int8 else dtype
    q = torch.randn(cube + (B, 1, H, hd), generator=torch.Generator()
                    .manual_seed(7)).to(qdt)
    q_pos = torch.full(cube + (B, 1), S - 3)
    k_pos = torch.arange(S).expand(cube + (B, S))
    lead = cube + (B,)
    kv = layers._decode_lead(k, lead)
    assert kv.shape == (8, B, S, KV, hd) and kv.data_ptr() == k.data_ptr()
    assert flash.lead_strides(kv, 3, B) == (k.stride(1), k.stride(2))
    kw = dict(q_pos=q_pos, k_pos=k_pos, partial=partial, window=9)
    got = layers.chunked_attention(q, k, v, **kw, **scales)
    want = layers.chunked_attention(
        q, k.contiguous(), v.contiguous(), **kw,
        **{n: t.contiguous() for n, t in scales.items()})
    for g_, w_ in zip(got if partial else (got,), want if partial else
                      (want,)):
        assert torch.equal(g_, w_)


def _check_args(k, v, B=8, Sq=1, H=4, hd=32, dtype=torch.bfloat16):
    q = torch.zeros((B, Sq, H, hd), dtype=dtype)
    q_pos = torch.zeros((B, Sq), dtype=torch.int32)
    k_pos = torch.zeros((B, k.shape[-3]), dtype=torch.int32)
    return q, k, v, q_pos, k_pos


def test_checks_accept_the_strided_lead_and_refuse_other_layouts():
    """``_check_layout`` / ``_check_scales`` take a (C, B_l, Sk, KV, hd)
    lead with any strides over a dense tail, in the decode form only, with
    16-byte row starts; every other non-contiguous k / v / scale is
    refused, as before."""
    k = layers._decode_lead(_unit_view(torch.bfloat16, B=2), (2, 4, 2))
    v = layers._decode_lead(_unit_view(torch.bfloat16, B=2), (2, 4, 2))
    geo = flash._check_layout(*_check_args(k, v, B=16))
    assert geo.form == "decode" and not k.is_contiguous()
    # the int8 cache with its scales in the same layout
    k8 = layers._decode_lead(_unit_view(torch.int8, B=2), (2, 4, 2))
    sc = torch.ones((2, 4, 3, 2, 24, 2)).select(2, 1)
    sc = layers._decode_lead(sc, (2, 4, 2))
    assert flash._check_layout(*_check_args(k8, k8, B=16), sc,
                               sc).form == "decode"
    # either of k and the scales may be contiguous beside the other's lead
    assert flash._check_layout(*_check_args(k8.contiguous(),
                                            k8.contiguous(), B=16),
                               sc, sc).form == "decode"
    flat = sc.reshape(16, 24, 2)
    assert flash._check_layout(*_check_args(k8, k8, B=16), flat,
                               flat).form == "decode"
    # a 4-D k that is not contiguous (the old layout's refusal)
    with pytest.raises(ValueError, match="contiguous"):
        kt = torch.zeros((16, 2, 24, 32), dtype=torch.bfloat16).transpose(1, 2)
        flash._check_layout(*_check_args(kt, kt, B=16))
    # a strided lead whose tail is not dense (KV and S swapped)
    kt = torch.zeros((8, 2, 2, 24, 32), dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="dense tail"):
        flash._check_layout(*_check_args(kt, kt, B=16))
    # k and v in other layouts
    with pytest.raises(ValueError, match="share"):
        flash._check_layout(*_check_args(k, v.contiguous(), B=16))
    # a lead row that starts off 16 bytes (one bf16 element in)
    base = torch.zeros(8 * 2 * 24 * 2 * 32 + 8, dtype=torch.bfloat16)
    odd = base.as_strided((8, 2, 24, 2, 32), (2 * 24 * 2 * 32 + 1,
                                              24 * 2 * 32, 64, 32, 1))
    with pytest.raises(ValueError, match="16-byte"):
        flash._check_layout(*_check_args(odd, odd, B=16))
    # the forward form (Sq * G > 8) takes contiguous k / v only
    with pytest.raises(ValueError, match="decode form only"):
        flash._check_layout(*_check_args(k, v, B=16, Sq=5))
    # scales that are neither contiguous nor a strided lead
    st = torch.ones((16, 2, 24)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash._check_layout(*_check_args(k8, k8, B=16), st, st)
    # a strided lead of another B_l than k's
    st = torch.ones((4, 4, 3, 24, 2)).select(2, 0)
    with pytest.raises(ValueError, match="one B_l"):
        flash._check_layout(*_check_args(k8, k8, B=16), st, st)


# ------------------------------------------- mode 2's p in the decode form
def _mode2_onehot_case(Sk):
    """Inputs whose scores are exact in bf16 (small integers, hd 64: the
    scale 1/8 is a power of two), repeated over nb = ceil(Sk / hd) batch
    entries whose one-hot v picks a block of hd keys each (acc[d] is one
    key's p), the last 4 keys masked (causal, q at Sk - 5). From 2,048 keys
    on, key Sk - 10 (in the last chunk) is each group's first query head,
    so a later chunk raises that head's max."""
    hd, H, KV, Sq = 64, 8, 2, 1
    nb = -(-Sk // hd)
    rng = np.random.RandomState(Sk)
    q1 = rng.randint(-1, 2, (1, Sq, H, hd)).astype(np.float32)
    k1 = rng.randint(-1, 2, (1, Sk, KV, hd)).astype(np.float32)
    if Sk >= 2048:
        k1[0, Sk - 10] = q1[0, 0, ::H // KV]
    q, k = np.repeat(q1, nb, 0), np.repeat(k1, nb, 0)
    v = np.zeros((nb, Sk, KV, hd), np.float32)
    for b in range(nb):                 # batch b: keys [b hd, (b + 1) hd)
        for d in range(min(hd, Sk - b * hd)):
            v[b, b * hd + d, :, d] = 1.0
    q0 = Sk - 5
    pos = (torch.full((nb, Sq), q0, dtype=torch.int32),
           torch.arange(Sk, dtype=torch.int32).expand(nb, Sk))
    return (q1, k1), (q, k, v), q0, pos


def _onehot_p(acc, Sk):
    """(H, Sq, Sk) p of the one-hot partials (B, H, Sq, hd)."""
    nb, H, Sq, hd = acc.shape
    return acc.permute(1, 2, 0, 3).reshape(H, Sq, nb * hd)[..., :Sk]


@pytest.mark.parametrize("Sk", [37, 300, 1024, 2048, 3008])
def test_mode2_p_is_rounded_against_the_row_max_as_jax_rounds_it(
        monkeypatch, Sk):
    """The reference's mode 2 runs its keys in nc = Sk // min(1024, Sk)
    chunks and rounds p = bf16(exp(bf16(s - bf16(M_c)))) against M_c, the
    running max over the chunks up to the key's own: the row's max below
    2,048 keys (one chunk), 2 x 1,024 and 2 x 1,504 chunks at 2,048 and
    3,008. The plain version's p, read one key at a time through one-hot
    v, is JAX's ``_chunked_attention`` at ``LOWP = 2`` bit for bit in the
    last chunk and, in an earlier one, within one f32 exp (JAX rescales it
    by exp(M_0 - M_1) in f32, the port by exp(M_c - m)); m is JAX's bit for
    bit. The controls: p rounded against a running max over 64-key blocks
    (one chunk), or against the row's max (several chunks), is not."""
    import repro.models.layers as jax_layers
    monkeypatch.setattr(jax_layers, "LOWP", 2)
    (q1, k1), arrs, q0, pos = _mode2_onehot_case(Sk)
    Sq, H, hd = q1.shape[1:]
    KV = k1.shape[2]
    j_acc, j_m, j_l = jax_layers._chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), causal=True,
        q_offset=q0, partial=True)
    t = [torch.from_numpy(a).bfloat16() for a in arrs]
    acc, m, l = ref.flash_attention(*t, *pos, partial=True, lowp=2)
    # JAX's (B, KV, G, Sq, hd) partials are the port's (B, H, Sq, hd)
    p_port = _onehot_p(acc, Sk)
    p_jax = _onehot_p(torch.from_numpy(np.array(j_acc)).reshape(acc.shape),
                      Sk)
    nc, C = ref.lowp_chunks(Sk)
    last = (nc - 1) * C
    assert torch.equal(p_port[..., last:], p_jax[..., last:])
    torch.testing.assert_close(p_port[..., :last], p_jax[..., :last],
                               rtol=1e-6, atol=0)
    assert torch.equal(m, torch.from_numpy(np.array(j_m)).reshape(m.shape))
    # l sums the same p in f32 (JAX's CPU sum of its bf16 p reads 4e-4
    # apart, so l is held to the port's own p)
    torch.testing.assert_close(l, p_port.sum(-1).expand_as(l), rtol=1e-6,
                               atol=0)
    assert (p_port[..., :Sk - 4] > 0).all()
    assert (p_port[..., Sk - 4:] == 0).all()
    s = ref.bf16(torch.einsum("qhd,khd->hqk", ref.bf16(
        torch.from_numpy(q1[0]) * 0.125),
        torch.from_numpy(k1[0]).repeat_interleave(H // KV, dim=1)))
    s = torch.where(torch.arange(Sk) <= q0, s, ref.bf16_scalar(ref.NEG_INF))
    m_row = s.amax(-1, keepdim=True)
    if nc > 1:
        # the control: p against the row's max, which a later chunk raised
        assert bool((ref.chunk_max(s)[..., 0] < m_row[..., 0]).any())
        p_row = ref.bf16(torch.exp(ref.bf16(s - ref.bf16(m_row))))
        live = p_port > 0
        rel = ((p_row - p_port).abs()[live] / p_port[live]).max()
        assert float(rel) >= 2.0 ** -9
        return
    # the control: p against a running max over 64-key blocks
    run = torch.cat([s[..., :i + 1].amax(-1, keepdim=True) if i < 64 else
                     torch.maximum(s[..., :64].amax(-1, keepdim=True),
                                   s[..., 64:i + 1].amax(-1, keepdim=True))
                     for i in range(Sk)], dim=-1)
    p_blocks = ref.bf16(torch.exp(ref.bf16(s - ref.bf16(run)))) \
        * torch.exp(run - m_row)
    assert torch.allclose(p_blocks, p_port, rtol=1e-2, atol=0)
    if Sk > 64:
        assert not torch.equal(p_blocks, p_port)


@pytest.mark.parametrize("Sk", [2048, 3008])
@pytest.mark.parametrize("mode", [0, 1])
def test_modes_0_and_1_keep_their_function_over_several_chunks(
        monkeypatch, Sk, mode):
    """The chunk rule is mode 2's alone: at the lengths where the
    reference runs two key chunks, modes 0 and 1 of the plain version keep
    their single-pass p, exp(s - m) against the row's max (mode 1 rounded
    to bf16 for p v alone), and hold to JAX's ``_chunked_attention`` in
    the same mode: m bit for bit, l within f32 rounding, acc within one f32
    exp in mode 0. In mode 1 JAX rounds p for p v against its chunk's
    running max, the port against the row's: acc within two bf16 roundings
    of p (2^-7 relative), a difference the bf16 tolerance holds."""
    import repro.models.layers as jax_layers
    monkeypatch.setattr(jax_layers, "LOWP", mode)
    _, arrs, q0, pos = _mode2_onehot_case(Sk)
    j_acc, j_m, j_l = jax_layers._chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), causal=True,
        q_offset=q0, partial=True)
    t = [torch.from_numpy(a).bfloat16() for a in arrs]
    acc, m, l = ref.flash_attention(*t, *pos, partial=True, lowp=mode)
    assert torch.equal(m, torch.from_numpy(np.array(j_m)).reshape(m.shape))
    torch.testing.assert_close(
        acc, torch.from_numpy(np.array(j_acc)).reshape(acc.shape),
        rtol=2.0 ** -7 if mode else 1e-6, atol=0)
    torch.testing.assert_close(
        l, torch.from_numpy(np.array(j_l)).reshape(l.shape), rtol=1e-5,
        atol=0)
    # p against the row's max: the single-pass softmax of the scores
    p = _onehot_p(acc, Sk)
    qs = (ref.bf16(t[0].float() * ref.bf16_scalar(0.125)) if mode
          else t[0].float() * 0.125)
    s = torch.einsum("qhd,khd->hqk", qs[0], t[1][0].float()
                     .repeat_interleave(qs.shape[2] // t[1].shape[2], 1))
    s = torch.where(torch.arange(Sk) <= q0, s, ref.NEG_INF)
    want = torch.exp(s - s.amax(-1, keepdim=True))
    torch.testing.assert_close(p, ref.bf16(want) if mode else want,
                               rtol=1e-6, atol=0)


# (B, Sq, Sk, H, KV, hd, window, q0, k0): one case per form, and a forward
# whose first rows see no key while its later rows skip tiles; each again
# at head_dim 96 (G = 1) and 256 (G = 4)
CARD_CASES = {
    "decode": (3, 1, 37, 8, 2, 128, 16, 30, -2),
    "forward": (3, 40, 37, 8, 2, 128, 16, 30, -2),
    "no_visible_key": (2, 30, 200, 4, 2, 64, -1, 90, 100),
    "decode_hd96": (3, 2, 37, 8, 8, 96, 16, 30, -2),
    "forward_hd96": (3, 40, 37, 8, 8, 96, 16, 30, -2),
    "no_visible_key_hd96": (2, 30, 200, 4, 4, 96, -1, 90, 100),
    "decode_hd256": (3, 2, 37, 8, 2, 256, 16, 30, -2),
    "forward_hd256": (3, 40, 37, 4, 1, 256, 16, 30, -2),
    "no_visible_key_hd256": (2, 30, 200, 4, 1, 256, -1, 90, 100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("partial", [False, True])
def test_kernel_matches_plain_version_on_the_card(dtype, partial, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, Sq, Sk, H, KV, hd, window, q0, k0 = CARD_CASES[case]
    (q, k, v), _ = _inputs(2, B, Sq, Sk, H, KV, hd, dtype)
    q, k, v = (t.cuda() for t in (q, k, v))
    q_pos = (torch.arange(Sq, device="cuda") + q0).expand(B, Sq)
    k_pos = torch.arange(Sk, device="cuda").expand(B, Sk) + k0
    q_pos, k_pos = (p.to(torch.int32).contiguous() for p in (q_pos, k_pos))
    geo = flash.launch_geometry(B, Sq, Sk, H, KV, hd, q.dtype)
    assert geo.form == ("decode" if case.startswith("decode")
                        else "forward")
    before = flash.LAUNCHES
    got = ops.flash_attention(q, k, v, q_pos, k_pos, window=window,
                              partial=partial)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + 1
    want = ref.flash_attention(q, k, v, q_pos, k_pos, window=window,
                               partial=partial)
    tol = TOL[dtype]
    for g, w in zip(got if partial else (got,), want if partial else (want,)):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)
    dead = ~ref.mask(q_pos, k_pos, True, window).any(-1)      # (B, Sq)
    if case.startswith("no_visible_key"):
        assert dead.any() and not dead.all()
    if partial:
        m, l = got[1].transpose(1, 2)[dead], got[2].transpose(1, 2)[dead]
        assert bool((m == -1e30).all()) and bool((l == Sk).all())
    else:
        mean_v = v.float().mean(1).repeat_interleave(H // KV, dim=1)
        rows = got.float()[dead]                     # (n, H, hd)
        want_rows = mean_v[:, None].expand(B, Sq, H, hd)[dead]
        torch.testing.assert_close(rows, want_rows, atol=tol, rtol=0)


@pytest.mark.cuda
def test_check_raises_on_misaligned_tensor_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    (q, k, v), _ = _inputs(4, 1, 2, 8, 4, 2, 64, "bfloat16")
    q, k, v = (t.cuda() for t in (q, k, v))
    q_pos = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    k_pos = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    buf = torch.zeros(k.numel() + 1, dtype=k.dtype, device="cuda")
    k_off = buf[1:].view(k.shape)
    k_off.copy_(k)
    before = flash.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        flash.flash_attention(q, k_off, v, q_pos, k_pos)
    assert flash.LAUNCHES == before
