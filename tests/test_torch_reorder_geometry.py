"""``reorder.plan`` on the CPU: the launch geometry of the reorder kernel
(``csrc/reorder.cu``), which the wrapper passes to the C entry point and the
entry point checks. Over block sizes of 2 B to 1.25 MiB, 1 to 200,000
blocks and pointer alignments of 2, 4, 8 and 16 bytes: the word is the
widest both allow, a CTA has 256 threads, the grid has one CTA per 256
words within grid.x's limit, the index turns 64-bit past 2^31 - 1 words,
and the kernel's loop (modelled here step by step) writes every output word
exactly once. A model of the kernel's word map (word w, its block by the
host's magic divisor or by a 64-bit divide, its source word) equals
``ref.tile_swizzle`` bit for bit, zero blocks included; and the magic
divisor equals ``//`` for every block size up to 8 KiB at 2-byte words and
for sampled ones up to 2^31 - 1. No JAX needed: the kernel's function is
``ref.tile_swizzle``, which ``test_torch_reorder.py`` holds to JAX."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.reorder import ref, reorder

BLOCK_BYTES = (2, 6, 16, 48, 128, 208, 256, 832, 1024, 4080, 4096, 4112,
               8192, 32768, 163840, 1310720)
GS = (1, 3, 8, 512, 4099, 132096, 200000)
ALIGNS = (2, 4, 8, 16)
COVER_WORDS = 1 << 18      # enumerate coverage up to this many words
TOP = 2 ** 31 - 1


def _words(g, n):
    """Every word the kernel's loop visits, in its order: CTA c, lane t,
    iteration k -> c * T + t + k * grid * T, while below n."""
    T = g.threads
    step = g.grid * T
    w0 = (np.arange(g.grid)[:, None] * T + np.arange(T)[None, :]).reshape(-1)
    w = w0[:, None] + np.arange(-(-n // step))[None, :] * step
    return w[w < n]


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("block_bytes", BLOCK_BYTES)
def test_plan_geometry(block_bytes, align):
    for G in GS:
        g = reorder.plan(G, block_bytes, align)
        assert g.width in reorder.WIDTHS
        assert align % g.width == 0 and block_bytes % g.width == 0
        assert not any(align % w == 0 and block_bytes % w == 0
                       for w in reorder.WIDTHS if w > g.width)
        assert g.block_words * g.width == block_bytes
        assert g.threads == 256
        n = G * g.block_words
        assert g.grid == min(-(-n // g.threads), reorder.MAX_GRID) >= 1
        assert g.index_bits == (32 if n <= TOP else 64)
        assert (g.mul, g.shr) == (reorder.magic(g.block_words)
                                  if g.index_bits == 32 else (0, 0))
        if n <= COVER_WORDS:
            hits = np.bincount(_words(g, n), minlength=n)
            assert hits.shape == (n,) and (hits == 1).all()


def test_index_turns_64_bit_past_2_31_words():
    # 2-byte blocks at 2-byte alignment: one word a block
    g = reorder.plan(TOP, 2, 2)
    assert (g.index_bits, g.block_words) == (32, 1)
    assert g.grid == -(-TOP // 256)
    # 4-byte blocks at 2-byte words: 2^31 words at 2^30 blocks
    assert reorder.plan(2 ** 30 - 1, 4, 2).index_bits == 32
    g = reorder.plan(2 ** 30, 4, 2)
    assert (g.index_bits, g.mul, g.shr) == (64, 0, 0)
    # 2,050-byte blocks of bf16 at 2-byte words (the card test's 4.3 GB):
    # 1,025 words a block
    assert reorder.plan(2 ** 31 // 1025, 2050, 2).index_bits == 32
    assert reorder.plan(2 ** 31 // 1025 + 1, 2050, 2).index_bits == 64
    # the widest block count at 16-byte words of 1.25 MiB: grid.x capped
    g = reorder.plan(TOP, 1310720, 16)
    assert g.index_bits == 64 and g.grid == reorder.MAX_GRID


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="2-byte word"):
        reorder.plan(4, 7, 16)
    with pytest.raises(ValueError, match="2-byte word"):
        reorder.plan(4, 16, 1)
    with pytest.raises(ValueError, match="no plan"):
        reorder.plan(0, 16, 16)
    with pytest.raises(ValueError, match="no plan"):
        reorder.plan(2 ** 31, 16, 16)
    with pytest.raises(ValueError, match="no plan"):
        reorder.plan(4, 0, 16)


def _check_magic(d, n):
    mul, shr = reorder.magic(d)
    n = np.asarray(n, dtype=np.uint64)
    n = n[n < 2 ** 31]
    q = n if d == 1 else ((n * np.uint64(mul)) >> np.uint64(32)) >> \
        np.uint64(shr)
    np.testing.assert_array_equal(q, n // np.uint64(d), err_msg=f"d={d}")
    assert 0 <= mul < 2 ** 32


def test_magic_divisor_every_block_up_to_8_kib():
    """Every block_words up to 4,096 (blocks up to 8 KiB at 2-byte words):
    the numerators at the top of the 31-bit range (where the error is
    largest), at each multiple's edges near 0, and a random draw."""
    rng = np.random.RandomState(0)
    for d in range(1, 4097):
        k = np.arange(0, 64, dtype=np.int64)
        n = np.concatenate([np.arange(TOP - 2 * d - 1, TOP + 1),
                            (k * d)[:, None] + np.array([-1, 0, 1]),
                            rng.randint(0, TOP, 256)], axis=None)
        _check_magic(d, n[n >= 0])


def test_magic_divisor_large_blocks():
    """block_words above 4,096, which the 32-bit index takes while the
    payload stays under 2^31 words: powers of two and their neighbours, a
    random draw and 2^31 - 1, at the range's top and random numerators."""
    rng = np.random.RandomState(1)
    ds = sorted({d for b in range(12, 31) for d in (2 ** b - 1, 2 ** b,
                                                    2 ** b + 1)}
                | set(rng.randint(4097, TOP, 64).tolist()) | {TOP})
    for d in ds:
        n = np.concatenate([np.arange(TOP - 4096, TOP + 1),
                            TOP - (np.arange(1, 64) * d) % TOP,
                            rng.randint(0, TOP, 4096)])
        _check_magic(d, n)
    with pytest.raises(ValueError):
        reorder.magic(0)
    with pytest.raises(ValueError):
        reorder.magic(2 ** 31)


def _model(xb, perm, g, G):
    """The kernel's word map on the bytes ``xb`` of G blocks: each output
    word from its source word, or zero where perm's entry is outside [0,
    G), step by step as the plan's index width computes it."""
    bw = g.block_words
    words = xb.view(np.dtype(f"V{g.width}"))
    out = np.zeros_like(words)
    w = _words(g, G * bw).astype(np.uint64)
    if g.index_bits == 64:
        i = w // np.uint64(bw)
    elif g.mul == 0:
        i = w
    else:
        i = ((w * np.uint64(g.mul)) >> np.uint64(32)) >> np.uint64(g.shr)
    off = w - i * np.uint64(bw)
    p = np.asarray(perm, dtype=np.int64)[i.astype(np.int64)]
    p = p.astype(np.uint32).astype(np.int64)     # unsigned: -1 is out too
    ok = p < G
    w, src = w.astype(np.int64), p * bw + off.astype(np.int64)
    out[w[ok]] = words[src[ok]]
    return out.view(np.uint8)


def _want(x, perm, G):
    """ref.tile_swizzle with the out-of-range entries' blocks zero."""
    perm = np.asarray(perm)
    bad = (perm < 0) | (perm >= G)
    want = ref.tile_swizzle(x, np.where(bad, 0, perm)).reshape(G, -1)
    want[torch.from_numpy(bad)] = 0
    return want.contiguous().view(torch.uint8).reshape(-1).numpy()


@pytest.mark.parametrize("G,D,dtype,align", [
    (132096, 8, torch.float32, 4),       # 32-byte blocks in 4-byte words
    (132096, 128, torch.bfloat16, 16),   # the qwen3 reshard's 256 B
    (16384, 208, torch.float32, 16),     # DLRM's 832 B, 52 words
    (3072, 64, torch.bfloat16, 8),       # whisper's 128 B in 8-byte words
    (4099, 3, torch.bfloat16, 2),        # 6-byte blocks: 2-byte words
    (1024, 1024, torch.int32, 16),       # the MoE decode's 4 KiB
    (64, 2056, torch.bfloat16, 8),       # 4,112 B: 514 words
    (16, 81920, torch.bfloat16, 2),      # 160 KiB at 2-byte words
    (1, 8, torch.bfloat16, 16),          # the launch floor: one word
])
def test_word_map_matches_the_plain_version(G, D, dtype, align):
    rng = np.random.RandomState(G + D)
    x = torch.from_numpy(rng.randint(-2 ** 15, 2 ** 15, (G, D))).to(dtype)
    perm = rng.permutation(G)
    if G > 2:
        perm[[1, G // 2]] = [-1, G + 3]      # two zero blocks
    xb = x.contiguous().view(torch.uint8).reshape(-1).numpy()
    g = reorder.plan(G, D * x.element_size(), align)
    assert g.index_bits == 32 and G * g.block_words <= 1 << 22
    want = _want(x, perm, G)
    # as planned; the 64-bit index's divide on the same words; and a grid
    # of 3 CTAs, whose loop strides as past grid.x's limit
    for h in (g, g._replace(index_bits=64, mul=0, shr=0),
              g._replace(grid=min(3, g.grid))):
        np.testing.assert_array_equal(_model(xb, perm, h, G), want,
                                      err_msg=str(h))
