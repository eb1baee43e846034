"""The port's paged KV cache (``repro_torch.serving.pages``) on the CPU,
case for case with ``tests/test_paging.py``: the host page table against
the pure-NumPy oracle and the JAX ``PageTable``, the device gather/scatter
view against the NumPy paged view, the rooted-collective swap round trip,
and paged decode bit-identical (bf16, max |diff| == 0.0) to the
contiguous-cache ``Server.decode_shard`` across architectures, including a
rolling-window cache (mixtral's window-8 cache wraps blocks) and a
multi-shard (tp=2) kv group."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.launch.mesh import make_mesh
from repro.models.serving import make_serve_plan as jax_make_serve_plan
from repro.models.topology import build_serve_topology as jax_serve_topology
from repro.serving import pages as jax_pages
from repro.testing.paging import PageTableOracle, paged_view

from repro_torch import configs
from repro_torch.models.params import init_params
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology
from repro_torch.serving.pages import (
    PAGED_KEYS, PagedServer, PagePlan, PageTable, extract_slot_pages,
    gather_view, init_paged_cache, inject_slot_pages, local_block_ids,
    make_page_plan, paged_cache_defs, scatter_view)

CPU = torch.device("cpu")


def _table(page, pps, nsh, S_cache, slots, cls=PageTable, plan_cls=PagePlan):
    S_loc = S_cache // nsh
    pplan = plan_cls(page_size=page, pages_per_shard=pps, n_shards=nsh,
                     S_loc=S_loc, blocks_per_shard=S_loc // page,
                     n_blocks=(S_loc // page) * nsh)
    return cls(pplan, slots)


# --------------------------------------------------- table vs NumPy oracle
def test_page_table_matches_oracle_and_jax():
    """Random ensure/free/admit interleavings: every observable (tables,
    free lists, return values, admission math) matches the independent
    NumPy implementation and the JAX package's table step for step."""
    rng = np.random.RandomState(0)
    page, pps, nsh, S_cache, slots = 4, 5, 2, 32, 3
    impl = _table(page, pps, nsh, S_cache, slots)
    ref = _table(page, pps, nsh, S_cache, slots, jax_pages.PageTable,
                 jax_pages.PagePlan)
    orac = PageTableOracle(page, pps, nsh, S_cache, slots)
    for t in range(400):
        r = rng.rand()
        if r < 0.6:
            s, p = rng.randint(slots), rng.randint(S_cache)
            got = impl.ensure(s, p)
            assert got == orac.ensure(s, p) == ref.ensure(s, p), (t, s, p)
        elif r < 0.8:
            s = rng.randint(slots)
            got = impl.free_slot(s)
            assert got == orac.free_slot(s) == ref.free_slot(s), (t, s)
        else:
            n = rng.randint(1, S_cache + 4)
            assert impl.blocks_needed(n) == orac.blocks_needed(n) \
                == ref.blocks_needed(n)
            assert impl.can_admit(n) == orac.can_admit(n) == ref.can_admit(n)
        assert np.array_equal(impl.table, orac.table), t
        assert np.array_equal(impl.array(), ref.array()), t
        assert [list(f) for f in impl.free] == orac.free == ref.free, t


@pytest.mark.parametrize("tp,page,pages", [(1, 4, None), (2, 4, None),
                                           (2, 2, 3)])
def test_page_plan_and_pool_defs_match_jax(tp, page, pages):
    """The page geometry and the pool shapes equal the JAX package's."""
    cfg = dataclasses.replace(configs.get("qwen3-1.7b").scaled_for_smoke(),
                              tp=tp)
    jcfg = dataclasses.replace(jax_get("qwen3-1.7b").scaled_for_smoke(),
                               tp=tp)
    topo = build_serve_topology(cfg, tp)
    jtopo = jax_serve_topology(jcfg, make_mesh((1, tp), ("data", "model")))
    plan = make_serve_plan(cfg, topo, S_ctx=16, global_batch=3)
    jplan = jax_make_serve_plan(jcfg, jtopo, S_ctx=16, global_batch=3)
    pplan = make_page_plan(plan, topo, page_size=page, pages_per_shard=pages)
    jpplan = jax_pages.make_page_plan(jplan, jtopo, page_size=page,
                                      pages_per_shard=pages)
    assert dataclasses.asdict(pplan) == dataclasses.asdict(jpplan)
    defs = paged_cache_defs(cfg, topo, plan, pplan)
    jdefs = jax_pages.paged_cache_defs(jcfg, jtopo, jplan, jpplan)
    assert {p: {k: v[0] for k, v in d.items()} for p, d in defs.items()} == \
        {p: {k: v[0] for k, v in d.items()} for p, d in jdefs.items()}
    pc = init_paged_cache(cfg, topo, plan, pplan, device=CPU)
    leaf = pc["p0"]["k"]
    assert leaf.shape == topo.cube.dim_sizes + (
        cfg.n_layers, pplan.pool_pages, page, cfg.n_kv_heads, cfg.head_dim)
    assert not leaf.any()
    with pytest.raises(ValueError, match="does not divide"):
        make_page_plan(plan, topo, page_size=3)


# ------------------------------------------- gather/scatter view vs NumPy
def test_gather_view_matches_numpy_oracle():
    """Every PE's view at once (the cube axis carries the shard) against
    the NumPy paged view of each shard; scatter_view is gather_view's right
    inverse on allocated blocks and writes the pools in place."""
    rng = np.random.RandomState(1)
    page, pps, nsh, S_cache, B = 4, 6, 2, 32, 3
    impl = _table(page, pps, nsh, S_cache, B)
    pplan = impl.pplan
    for s in range(B):
        for p in rng.choice(S_cache, size=rng.randint(2, S_cache),
                            replace=False):
            impl.ensure(s, int(p))
    pools = rng.randn(nsh, 2, pplan.pool_pages, page, 5).astype(np.float32)
    pool = torch.from_numpy(pools.copy())
    table = torch.from_numpy(impl.array()).expand((nsh,) + impl.table.shape)
    shard = torch.arange(nsh)
    safe, valid = local_block_ids(pplan, table, shard)
    assert safe.shape == valid.shape == (nsh, B, pplan.blocks_per_shard)
    got = gather_view(pool, safe, valid, pplan, 1)
    for sh in range(nsh):
        want = paged_view(pools[sh], impl.array(), sh, page,
                          pplan.blocks_per_shard)
        assert np.array_equal(got[sh].numpy(), want), sh
    back = scatter_view(pool, got.clone(), safe, pplan, 1)
    assert back is pool
    re = gather_view(pool, safe, valid, pplan, 1)
    assert torch.equal(re, got)
    # the view is fresh: writing it leaves the pools alone
    got.fill_(7.0)
    assert torch.equal(gather_view(pool, safe, valid, pplan, 1), re)


# ------------------------------------- paged decode vs contiguous decode
def _run_diff(arch, *, tp=1, S=16, B=2):
    """Teacher-forced bf16 decode, paged vs contiguous, step by step.
    Returns the worst absolute logits difference (0.0 = bit-identical)."""
    cfg = configs.get(arch).scaled_for_smoke()
    if tp > 1:
        cfg = dataclasses.replace(cfg, tp=tp)
    topo = build_serve_topology(cfg, tp)
    plan = make_serve_plan(cfg, topo, S_ctx=S, global_batch=B)
    pplan = make_page_plan(plan, topo, page_size=4)
    params = init_params(cfg, topo, 1, device=CPU)
    server = Server(cfg, topo, plan)
    paged = PagedServer(server, pplan)
    cache = init_cache(cfg, topo, plan, device=CPU)
    pcache = init_paged_cache(cfg, topo, plan, pplan, device=CPU)
    tbl = PageTable(pplan, B)
    kvc, cube = topo.comm(plan.kv_axes), topo.cube

    rng = np.random.RandomState(7)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S)))
    worst = 0.0
    for t in range(S):
        for b in range(B):
            assert tbl.ensure(b, t % plan.S_cache)
        pos = cube.to_cube(torch.full((B,), t), (None,))
        tok = cube.to_cube(tokens[:, t], (None,))
        ref, cache = server.decode_shard(params, cache, tok, pos)
        got, pcache = paged.decode_shard(params, pcache,
                                         kvc.broadcast(tbl.array()), tok,
                                         pos)
        assert torch.isfinite(got).all()
        worst = max(worst, float((got - ref).abs().max()))
    return worst, plan


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b",
                                  "mixtral-8x7b"])
def test_paged_decode_bit_identical_bf16(arch):
    """bf16 caches: the paged path reconstructs the exact contiguous view
    and runs the unchanged flash-decode cell, so logits are bitwise equal
    -- incl. mixtral's rolling window-8 cache (block reuse on wrap)."""
    worst, plan = _run_diff(arch)
    assert worst == 0.0
    if arch == "mixtral-8x7b":
        assert plan.S_cache < plan.S_ctx        # the cache really rolls


def test_paged_decode_bit_identical_multishard():
    """tp=2 kv group: per-shard page pools, shard-local block ownership."""
    worst, _ = _run_diff("qwen3-1.7b", tp=2)
    assert worst == 0.0


# ------------------------------------------------- swap-out / swap-in
def test_swap_roundtrip_restores_views():
    """extract (rooted gather) -> free -> re-allocate -> inject (rooted
    scatter): every PE's reconstructed cache view of the swapped slot
    comes back bit-identical; the other slot's mapping is untouched."""
    cfg = dataclasses.replace(configs.get("qwen3-1.7b").scaled_for_smoke(),
                              tp=2)
    topo = build_serve_topology(cfg, 2)
    plan = make_serve_plan(cfg, topo, S_ctx=16, global_batch=2)
    pplan = make_page_plan(plan, topo, page_size=4)
    tbl = PageTable(pplan, 2)
    gen = torch.Generator().manual_seed(3)
    pcache = {p: {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                  for k, v in d.items()}
              for p, d in init_paged_cache(cfg, topo, plan, pplan,
                                           device=CPU).items()}
    for b in range(2):
        for t in range(0, 12):          # partial footprint: blocks 0..2
            tbl.ensure(b, t)
    cn, kvc = topo.cube.ndim, topo.comm(plan.kv_axes)

    def views(pc, slot):
        table = kvc.broadcast(tbl.array())
        safe, valid = local_block_ids(
            pplan, table, topo.axis_index(plan.kv_axes, CPU))
        return {(pk, k): gather_view(leaf, safe, valid, pplan, cn)
                .select(cn + 1, slot).clone()
                for pk, d in pc.items() for k, leaf in d.items()
                if k in PAGED_KEYS}

    before0 = views(pcache, 0)
    row1 = tbl.table[1].copy()
    saved = extract_slot_pages(pcache, tbl.table[0], 0, pplan, topo, plan,
                               cfg)
    assert saved["valid"].sum() == 3
    tbl.free_slot(0)
    # scrub every page so restoration can't luck into stale data
    for d in pcache.values():
        for leaf in d.values():
            leaf.fill_(-1)
    for j in np.nonzero(saved["valid"])[0]:
        assert tbl.ensure(0, int(j) * pplan.page_size)
    out = inject_slot_pages(pcache, saved, tbl.table[0], 0, pplan, topo,
                            plan, cfg)
    assert out is pcache
    after0 = views(pcache, 0)
    for key in before0:
        assert torch.equal(after0[key], before0[key]), key
    assert np.array_equal(tbl.table[1], row1)
