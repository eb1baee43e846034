"""Production decode serving on the PE hypercube: a paged/block KV cache
whose cross-cube page motion is rooted scatter/gather collectives
(:mod:`repro_torch.serving.pages`), and a continuous-batching engine whose
per-step host<->PE traffic is one recorded CommProgram served by the
structural-fingerprint lower cache (:mod:`repro_torch.serving.engine`).

The counterpart of ``repro.serving``.
"""
from repro_torch.serving.engine import Request, ServeEngine, poisson_trace
from repro_torch.serving.pages import (
    PAGED_KEYS, PagePlan, PagedServer, PageTable, extract_slot_pages,
    gather_view, init_paged_cache, inject_slot_pages, local_block_ids,
    make_page_plan, paged_cache_defs, scatter_view)

__all__ = [
    "PAGED_KEYS", "PagePlan", "PageTable", "PagedServer", "Request",
    "ServeEngine", "extract_slot_pages", "gather_view", "init_paged_cache",
    "inject_slot_pages", "local_block_ids", "make_page_plan",
    "paged_cache_defs", "poisson_trace", "scatter_view",
]
