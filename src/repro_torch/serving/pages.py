"""Paged/block KV cache: fixed-size KV blocks behind a per-request page
table, with cross-cube page exchange expressed as rooted scatter/gather
collectives on the serve topology.

The counterpart of ``repro.serving.pages`` over the port's in-process cube.
The contiguous decode cache (``repro_torch.models.serving.init_cache``)
allocates ``S_cache`` slots per request up front; a paged cache carves the
same slot space into fixed-size **blocks** (``page_size`` slots) drawn from
per-shard physical page pools, so short requests hold only the pages they
touched and freed pages are immediately reusable by the next admission
(slot reuse, continuous batching).

The pools are cube tensors ``(*cube, n_units, pool_pages, page, *tail)``:
PE ``c`` holds the pool of its kv shard. Where the reference computes each
shard's page ids inside ``shard_map`` from ``lax.axis_index``, here the
safe ids and the valid mask carry the cube axes, ``(*cube, B,
blocks_per_shard)``, and the gather / scatter index every PE's pool along
its page axis at once.

Layout invariants that make paged decode *bit-identical* to the contiguous
reference:

  * logical block ``j`` of any request covers cache slots
    ``[j*page_size, (j+1)*page_size)`` and is **owned** by the kv shard whose
    contiguous slot range contains it (``owner(j) = j // blocks_per_shard``).
    Allocation never crosses that boundary, so each shard can materialize its
    exact contiguous ``(B, S_loc, ...)`` cache view from purely local pages;
  * the view gather zero-fills unallocated blocks, matching the zero-init of
    the contiguous cache; stale data in a *reallocated* page sits at key
    positions the flash-decode mask already excludes (causality / ``dk >= 0``
    under rolling), and a masked key contributes exactly 0 -- while the
    pools hold only finite values: they start at zero and only finite K/V
    is written;
  * each shard's pool carries one extra **scratch** page: masked writes (a
    slot whose block is unallocated -- e.g. an idle batch lane) land there
    instead of scatter-aliasing a live page.

``PagedServer.decode_shard`` is therefore gather-view -> the *unchanged*
``Server.decode_shard`` flash-decode cell, which writes the new token into
the fresh view in place -> scatter-back into the pools. The view never
aliases a pool.

Page exchange across the cube boundary (preemption/swap in the engine) is
the rooted-collective pair of paper §IV-B3: ``extract_slot_pages`` gathers a
request's blocks PEs -> host (``comm.gather``), ``inject_slot_pages``
partitions them back host -> PEs along the block axis in owner order
(``comm.scatter``), with the per-request recurrent-state rows (RWKV) that
are not paged scattered under their own layout.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.serving import ServePlan, Server, cache_defs
from repro_torch.models.topology import Topology

# cache-tree keys that live in page pools; everything else (RWKV states,
# token-shift carries) stays a per-slot row exactly as in the contiguous
# layout
PAGED_KEYS = ("k", "v", "k_s", "v_s")


@dataclasses.dataclass(frozen=True)
class PagePlan:
    """Static geometry of the page pools for one (ServePlan, topology)."""
    page_size: int           # cache slots per block/page
    pages_per_shard: int     # usable physical pages per kv shard
    n_shards: int            # size of the kv group (plan.kv_axes)
    S_loc: int               # contiguous slots per shard (= S_cache / n)
    blocks_per_shard: int    # logical blocks of one request per shard
    n_blocks: int            # logical blocks per request (= S_cache / page)

    @property
    def pool_pages(self) -> int:
        """Physical page-axis extent per shard (usable + 1 scratch)."""
        return self.pages_per_shard + 1

    @property
    def n_pages_global(self) -> int:
        return self.n_shards * self.pool_pages

    def owner(self, block: int) -> int:
        """The kv shard whose contiguous slot range covers ``block``."""
        return block // self.blocks_per_shard


def make_page_plan(plan: ServePlan, topo: Topology, *, page_size: int = 4,
                   pages_per_shard: int | None = None) -> PagePlan:
    """Derive the page geometry. ``page_size`` must divide the per-shard
    cache extent so no block straddles a shard boundary; the default pool
    capacity covers every slot of every request (no paging pressure) --
    shrink ``pages_per_shard`` to exercise admission control/preemption."""
    n = topo.size(plan.kv_axes)
    S_loc = plan.S_cache // n
    if S_loc % page_size:
        raise ValueError(
            f"page_size {page_size} does not divide the per-shard cache "
            f"extent {S_loc} (S_cache {plan.S_cache} over {n} shards); "
            "pick a divisor so no block straddles a shard boundary")
    blocks_per_shard = S_loc // page_size
    if pages_per_shard is None:
        pages_per_shard = blocks_per_shard * plan.global_batch
    return PagePlan(page_size=page_size, pages_per_shard=pages_per_shard,
                    n_shards=n, S_loc=S_loc,
                    blocks_per_shard=blocks_per_shard,
                    n_blocks=blocks_per_shard * n)


# ------------------------------------------------------------- pool layout
def paged_cache_defs(cfg: ModelConfig, topo: Topology, plan: ServePlan,
                     pplan: PagePlan, dtype: torch.dtype = torch.bfloat16):
    """Like :func:`repro_torch.models.serving.cache_defs`, with the
    attention K/V entries re-laid as page pools: the per-request
    ``(B, S_cache)`` slot axes become a shared ``(n_pages_global,
    page_size)`` pool sharded over the kv axes along the page axis."""
    out = {}
    for pkey, d in cache_defs(cfg, topo, plan, dtype).items():
        nd = {}
        for k, (shp, spec, dt) in d.items():
            if k in PAGED_KEYS:
                # (n_units, B, S_cache, *tail) -> (n_units, pages, page, *tail)
                tail = shp[3:]
                nd[k] = ((shp[0], pplan.n_pages_global, pplan.page_size)
                         + tail,
                         (None, plan.kv_axes, None) + (None,) * len(tail),
                         dt)
            else:
                nd[k] = (shp, spec, dt)
        out[pkey] = nd
    return out


def init_paged_cache(cfg, topo, plan, pplan, *,
                     dtype: torch.dtype = torch.bfloat16, device) -> dict:
    """Zero pools as cube tensors ``(*cube, n_units, pool_pages, page,
    *tail)`` (a reallocated page is *not* re-zeroed at runtime -- the
    flash-decode mask makes that unnecessary)."""
    cube = topo.cube
    return {p: {k: torch.zeros(cube.dim_sizes + cube.local_shape(shp, spec),
                               dtype=dt, device=device)
                for k, (shp, spec, dt) in d.items()}
            for p, d in paged_cache_defs(cfg, topo, plan, pplan,
                                         dtype).items()}


# ------------------------------------------------- host-side page table
class PageTable:
    """Per-request page table + per-shard LIFO free lists (host side).

    ``table[slot, j]`` is the *local* page index of logical block ``j`` on
    its owner shard, or -1 while unallocated.  Blocks allocate lazily as a
    request's write position crosses a block boundary (``ensure``) and free
    as a batch on eviction (``free_slot``).
    """

    def __init__(self, pplan: PagePlan, max_slots: int):
        self.pplan = pplan
        self.max_slots = max_slots
        self.table = np.full((max_slots, pplan.n_blocks), -1, np.int32)
        # LIFO free lists: the page freed last is reused first, which keeps
        # the stale-data window (masked anyway) as short as possible
        self.free = [list(range(pplan.pages_per_shard - 1, -1, -1))
                     for _ in range(pplan.n_shards)]

    # -------------------------------------------------------- allocation
    def block_of(self, cache_pos: int) -> int:
        return int(cache_pos) // self.pplan.page_size

    def ensure(self, slot: int, cache_pos: int) -> bool:
        """Allocate the block covering ``cache_pos`` (a slot index within
        ``S_cache``; the caller applies any rolling modulus).  Returns False
        when the owner shard's free list is empty (admission control /
        preemption territory) without partial effects."""
        j = self.block_of(cache_pos)
        if self.table[slot, j] >= 0:
            return True
        sh = self.pplan.owner(j)
        if not self.free[sh]:
            return False
        self.table[slot, j] = self.free[sh].pop()
        return True

    def free_slot(self, slot: int) -> int:
        """Return every page of ``slot`` to its shard free list."""
        n = 0
        for j in range(self.pplan.n_blocks):
            pid = int(self.table[slot, j])
            if pid >= 0:
                self.free[self.pplan.owner(j)].append(pid)
                self.table[slot, j] = -1
                n += 1
        return n

    # ---------------------------------------------------------- capacity
    def free_per_shard(self) -> list[int]:
        return [len(f) for f in self.free]

    def blocks_needed(self, n_positions: int) -> list[int]:
        """Per-shard block count covering cache slots ``0..n_positions-1``
        (capped at the full cache extent)."""
        pp = self.pplan
        nb = min(-(-int(n_positions) // pp.page_size), pp.n_blocks)
        need = [0] * pp.n_shards
        for j in range(nb):
            need[pp.owner(j)] += 1
        return need

    def can_admit(self, n_positions: int) -> bool:
        """True when every shard can cover the request's full eventual
        footprint -- the no-deadlock admission policy."""
        return all(f >= n for f, n in zip(self.free_per_shard(),
                                          self.blocks_needed(n_positions)))

    def array(self) -> np.ndarray:
        """Snapshot for the per-step replicated broadcast."""
        return self.table.copy()


# --------------------------------------- per-shard gather/scatter view
def local_block_ids(pplan: PagePlan, table: torch.Tensor,
                    shard: torch.Tensor):
    """Each PE's slice of the table: (safe local page ids, valid mask),
    both ``(*cube, B, blocks_per_shard)``. ``table``: ``(*cube, B,
    n_blocks)`` (every PE's copy of the broadcast table); ``shard``: each
    PE's kv-shard index, shape ``cube``. Unallocated blocks map to the
    scratch page so gathers/scatters stay branch-free."""
    bps = pplan.blocks_per_shard
    cols = (shard.to(table.device)[..., None] * bps
            + torch.arange(bps, device=table.device))      # (*cube, bps)
    cols = cols[..., None, :].expand(tuple(table.shape[:-1]) + (bps,))
    myt = torch.gather(table, -1, cols.long())
    valid = myt >= 0
    safe = torch.where(valid, myt, pplan.pages_per_shard).long()
    return safe, valid


def _pe_index(safe: torch.Tensor, cn: int):
    """(PE index (N, 1), page ids (N, B * bps)) over the flattened cube."""
    n = math.prod(safe.shape[:cn])
    return (torch.arange(n, device=safe.device)[:, None],
            safe.reshape(n, -1))


def gather_view(pool: torch.Tensor, safe: torch.Tensor, valid: torch.Tensor,
                pplan: PagePlan, cn: int) -> torch.Tensor:
    """Pools ``(*cube, n_units, pool_pages, page, *tail)`` -> each PE's
    contiguous cache view ``(*cube, n_units, B, S_loc, *tail)``, a fresh
    tensor. Unallocated blocks read as zeros (identical to the contiguous
    zero-init). ``cn``: the number of cube axes."""
    cube = tuple(pool.shape[:cn])
    U, tail = pool.shape[cn], tuple(pool.shape[cn + 3:])
    B, bps = safe.shape[cn:]
    pe, ids = _pe_index(safe, cn)
    flat = pool.reshape((pe.shape[0],) + tuple(pool.shape[cn:]))
    g = flat[pe, :, ids]                  # (N, B * bps, U, page, *tail)
    vm = valid.reshape((pe.shape[0], B * bps) + (1,) * (2 + len(tail)))
    g = torch.where(vm, g, torch.zeros((), dtype=pool.dtype,
                                       device=pool.device))
    g = g.movedim(2, 1)                   # (N, U, B * bps, page, *tail)
    return g.reshape(cube + (U, B, pplan.S_loc) + tail)


def scatter_view(pool: torch.Tensor, view: torch.Tensor, safe: torch.Tensor,
                 pplan: PagePlan, cn: int) -> torch.Tensor:
    """Write each PE's updated contiguous view back into its pool, IN PLACE,
    and return the pool. Blocks of unallocated slots route to the scratch
    page (never read); allocated page ids are unique by construction, so
    the scatter never aliases a live page."""
    U, tail = pool.shape[cn], tuple(pool.shape[cn + 3:])
    B, bps = safe.shape[cn:]
    pe, ids = _pe_index(safe, cn)
    flat = pool.view((pe.shape[0],) + tuple(pool.shape[cn:]))
    blocks = view.reshape((pe.shape[0], U, B * bps, pplan.page_size) + tail)
    flat[pe, :, ids] = blocks.movedim(1, 2)
    return pool


class PagedServer:
    """Paged decode cell: gather-view -> ``Server.decode_shard`` (unchanged
    flash-decode arithmetic, writing the new token into the fresh view in
    place) -> scatter-back into the pools."""

    def __init__(self, server: Server, pplan: PagePlan):
        self.server = server
        self.pplan = pplan

    def decode_shard(self, params, pcache, table: torch.Tensor,
                     tokens: torch.Tensor, pos: torch.Tensor):
        """One paged decode step. ``table``: (*cube, B, n_blocks) int, every
        PE's copy of the page table; tokens, pos: (*cube, B). Writes the
        pools (and any per-slot rows) in place; returns (logits, pcache)."""
        pplan, topo = self.pplan, self.server.topo
        cn = topo.cube.ndim
        shard = topo.axis_index(self.server.plan.kv_axes, table.device)
        safe, valid = local_block_ids(pplan, table, shard)
        view = {pkey: {k: gather_view(leaf, safe, valid, pplan, cn)
                       if k in PAGED_KEYS else leaf
                       for k, leaf in d.items()}
                for pkey, d in pcache.items()}
        logits, view = self.server.decode_shard(params, view, tokens, pos)
        for pkey, d in pcache.items():
            for k, leaf in d.items():
                if k in PAGED_KEYS:
                    scatter_view(leaf, view[pkey][k], safe, pplan, cn)
        return logits, pcache


# --------------------------------------------- cross-cube page exchange
def _slot_ids(pplan: PagePlan, table_row: np.ndarray, topo: Topology,
              plan: ServePlan, device):
    """One request's blocks as every PE's safe local page ids, (*cube, 1,
    blocks_per_shard), and the row's valid mask (n_blocks,)."""
    row = torch.as_tensor(np.asarray(table_row, np.int32), device=device)
    table = row.expand(topo.cube.dim_sizes + (1, pplan.n_blocks))
    shard = topo.axis_index(plan.kv_axes, device)
    safe, _ = local_block_ids(pplan, table, shard)
    return safe, np.asarray(table_row) >= 0


def _row_spec(pcache_defs, pkey: str, k: str) -> tuple:
    """A per-slot row's layout: its leaf spec with the batch entry
    dropped."""
    spec = pcache_defs[pkey][k][1]
    return (spec[0],) + tuple(spec[2:])


def extract_slot_pages(pcache, table_row: np.ndarray, slot: int,
                       pplan: PagePlan, topo: Topology, plan: ServePlan,
                       cfg: ModelConfig) -> dict:
    """Swap-out half of the page exchange: gather one request's pages (and
    its per-slot recurrent-state rows) PEs -> host through the rooted
    ``gather`` collective on the kv group. The caller frees the pages
    afterwards; the returned dict round-trips through
    :func:`inject_slot_pages`."""
    kvc = topo.comm(plan.kv_axes)
    cn = topo.cube.ndim
    leaf0 = next(iter(next(iter(pcache.values())).values()))
    safe, valid = _slot_ids(pplan, table_row, topo, plan, leaf0.device)
    defs = paged_cache_defs(cfg, topo, plan, pplan)
    pages, rows = {}, {}
    for pkey, d in pcache.items():
        for k, leaf in d.items():
            if k in PAGED_KEYS:
                pe, ids = _pe_index(safe, cn)
                flat = leaf.reshape((pe.shape[0],) + tuple(leaf.shape[cn:]))
                taken = flat[pe, :, ids].movedim(2, 1)   # (N, U, bps, ...)
                taken = taken.reshape(tuple(leaf.shape[:cn])
                                      + tuple(taken.shape[1:]))
                host = kvc.gather(taken, axis=1)
                host[:, torch.from_numpy(~valid)] = 0    # scratch: garbage
                pages[(pkey, k)] = host
            else:
                rows[(pkey, k)] = kvc.gather(
                    leaf.select(cn + 1, slot), spec=_row_spec(defs, pkey, k))
    return {"pages": pages, "rows": rows, "valid": valid}


def inject_slot_pages(pcache, saved: dict, table_row: np.ndarray, slot: int,
                      pplan: PagePlan, topo: Topology, plan: ServePlan,
                      cfg: ModelConfig):
    """Swap-in half: partition the saved pages back host -> PEs with the
    rooted ``scatter`` along the block axis (blocks sit in owner order, so
    the equal per-shard split lands each page on the shard that owns it),
    scatter the per-slot state rows under their own layout, and write both
    into the cache IN PLACE at the freshly allocated ids in ``table_row``.
    Returns ``pcache``."""
    kvc = topo.comm(plan.kv_axes)
    cn = topo.cube.ndim
    leaf0 = next(iter(next(iter(pcache.values())).values()))
    dev = leaf0.device
    safe, _ = _slot_ids(pplan, table_row, topo, plan, dev)
    defs = paged_cache_defs(cfg, topo, plan, pplan)
    for (pkey, k), host in saved["pages"].items():
        leaf = pcache[pkey][k]
        blocks = kvc.scatter(host, axis=1, device=dev)  # (*cube, U, bps, ..)
        pe, ids = _pe_index(safe, cn)
        flat = leaf.view((pe.shape[0],) + tuple(leaf.shape[cn:]))
        blocks = blocks.reshape((pe.shape[0],) + tuple(blocks.shape[cn:]))
        flat[pe, :, ids] = blocks.movedim(1, 2).to(leaf.dtype)
    for (pkey, k), host in saved["rows"].items():
        leaf = pcache[pkey][k]
        leaf.select(cn + 1, slot).copy_(kvc.scatter(
            host, spec=_row_spec(defs, pkey, k), device=dev))
    return pcache


__all__ = [
    "PAGED_KEYS", "PagePlan", "PageTable", "PagedServer",
    "extract_slot_pages", "gather_view", "init_paged_cache",
    "inject_slot_pages", "local_block_ids", "make_page_plan",
    "paged_cache_defs", "scatter_view",
]
