"""Matmul comm fusions: all-gather prologues and reduce-scatter epilogues.

The counterpart of ``repro.kernels.collective.matmul``. The tensor-parallel
blocks of ``repro_torch.models.blocks`` bracket every matmul with a
sequence all_gather and a reduce_scatter; these wrappers push that movement
into the compute through the registered ring flows:

* :func:`all_gather_matmul` -- ``ag_prologue``: row-wise compute (norm +
  up-projection) runs per source block as the ring delivers it; the result
  is ``block_fn(all_gather(x))`` up to the GEMM's rounding of a different
  row count (bit-identical on integer-valued payloads).
* :func:`matmul_reduce_scatter` -- ``rs_epilogue``: the output projection's
  partial product is produced one 1/G tile at a time inside the ring
  reduce-scatter, so the full partial sum never exists. The ring sums in
  hop order: integer-valued payloads are bit-identical, real-valued ones
  agree within rounding.

Operands are cube tensors; the weight of ``matmul_reduce_scatter`` is one
per PE, ``(*cube, K, N)``.
"""
from __future__ import annotations

import math

from repro_torch.core.comm import _itemsize
from repro_torch.kernels.collective.ring import dispatch_fused, take_block
from repro_torch.models.layers import cube_matmul

__all__ = ["all_gather_matmul", "matmul_reduce_scatter"]


def all_gather_matmul(comm, x, *, axis: int, block_fn):
    """Fused gather-then-map: ``block_fn(all_gather(x, axis))`` with
    ``block_fn`` applied per delivered block. ``block_fn`` must be row-wise
    along ``axis`` (rms_norm and matmuls over the trailing dim qualify)."""
    if comm.group_size == 1:
        return block_fn(x)
    return dispatch_fused(comm, "all_gather", "ag_prologue", x,
                          axis=axis, block_fn=block_fn)


def matmul_reduce_scatter(comm, h, w, *, axis: int, op: str = "add"):
    """Fused ``reduce_scatter(h @ w, axis)`` per PE: tile t of the partial
    product is computed on demand (``h[tile t] @ w``) inside the ring. The
    length of ``h``'s payload ``axis`` must divide by the group size."""
    g = comm.group_size
    cn = comm.cube.ndim
    if g == 1:
        return cube_matmul(h, w, cn)
    L = h.shape[cn + axis]
    if L % g:
        raise ValueError(
            f"matmul_reduce_scatter: axis {axis} length {L} not divisible "
            f"by group size {g}")
    size = L // g

    def tile_fn(t):
        return cube_matmul(take_block(h, t, size, axis=axis), w, cn)

    # the logical pre-scatter buffer (g tiles of h @ w) never exists; its
    # byte count is what the planner prices, so hand it over explicitly
    tile_elems = math.prod(h.shape[cn:-1]) // g * w.shape[-1]
    payload = g * tile_elems * _itemsize(h.dtype)
    return dispatch_fused(comm, "reduce_scatter", "rs_epilogue", h,
                          payload_bytes=payload, axis=axis, op=op,
                          tile_fn=tile_fn)
