"""Ring-rotation algorithm bodies of the collective-fused flows.

The counterpart of ``repro.kernels.collective.ring``, registered here and
only here. On the in-process cube one ``ppermute`` hop of the ring is
:meth:`repro_torch.core.comm.Communicator.ring_shift`: member r of every
group receives what member r - 1 held. A block index that differs per PE
(the reference's traced ``axis_index`` arithmetic) is an int tensor of
shape ``cube.dim_sizes``.

``ring_fused``   (all_gather)  one source block delivered per hop; an
                 optional ``consume_fn`` merges each block in flight (ring
                 attention's kv loop), so the gathered array never
                 materializes. Without a consumer the body assembles the
                 gather: pure movement, bit-identical to the direct flow.
``ag_prologue``  (all_gather)  ring gather with a per-block prologue map:
                 row-wise compute (norm / matmul) runs on each source block
                 as it arrives. The identity map is a plain ring gather.
``rs_epilogue``  (reduce_scatter)  ring reduce-scatter whose per-tile
                 contribution is produced on demand (``tile_fn``), fusing a
                 matmul epilogue: the full partial-sum activation never
                 materializes. The ring sums in hop order, so it is
                 bit-identical to the direct flow on integer-valued
                 payloads and within rounding otherwise.

All three are ``stage="cm"`` / ``table_ii=False`` registry entries: none
widens the paper's Table II rows.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.comm import (
    CommEvent, _REDUCERS, _TRACES, _itemsize, _merge_blocks, get_algorithm,
    register_algorithm)
from repro_torch.models.layers import pe_slice

__all__ = ["dispatch_fused", "take_block"]


def take_block(x: torch.Tensor, t: torch.Tensor, size: int, *,
               axis: int) -> torch.Tensor:
    """Block ``t`` (length ``size``) of each PE's payload ``axis``; ``t`` is
    an int tensor of shape ``cube.dim_sizes`` (PE c takes block t[c])."""
    return pe_slice(x, t * size, size, axis, t.dim())


def _tree_map(fn, block):
    return tuple(fn(b) for b in block) if isinstance(block, tuple) \
        else fn(block)


def _ring_deliveries(comm, block, consume, state):
    """Rotate ``block`` (a cube tensor or a tuple of them) around the
    group's ring. Every member's block reaches every member exactly once:
    hop s brings the block owned by member (me - s) % g.
    ``consume(state, src, block) -> state`` folds each delivery (``src``:
    the source member per PE, shape ``cube.dim_sizes``); hop 0 is the PE's
    own block."""
    g = comm.group_size
    dev = (block[0] if isinstance(block, tuple) else block).device
    me = comm.axis_index(dev)
    cur = block
    state = consume(state, me, cur)
    for s in range(1, g):
        cur = _tree_map(comm.ring_shift, cur)
        state = consume(state, (me - s) % g, cur)
    return state


def _assemble(comm, x, axis, block_fn):
    """The ring gather of ``block_fn`` of every delivered block, placed in
    source order and concatenated along payload ``axis``."""
    g = comm.group_size
    out = None
    me = torch.arange(g, device=x.device)
    cur = comm.group_view(x)
    for s in range(g):
        if s:
            cur = torch.roll(cur, 1, 0)      # one hop: r <- r - 1
        mapped = comm.group_view(block_fn(comm.from_group_view(cur)))
        if out is None:                       # (G_member, G_slot, ...)
            out = mapped.new_zeros((g,) + tuple(mapped.shape))
        out[me, (me - s) % g] = mapped
    return comm.from_group_view(_merge_blocks(out, 1,
                                              comm.payload_dim(axis)))


@register_algorithm("all_gather", "ring_fused", stage="cm", table_ii=False)
def _ag_ring_fused(comm, x, *, axis, consume_fn=None, init=None):
    """Ring all-gather. With ``consume_fn`` (state, src, block) -> state,
    each delivered block is merged in flight from ``init`` and the merged
    state is returned (ring attention). Without it, assembles the gathered
    array (bit-identical to the direct gather: pure movement)."""
    if consume_fn is not None:
        return _ring_deliveries(comm, x, consume_fn, init)
    return _assemble(comm, x, axis, lambda b: b)


@register_algorithm("all_gather", "ag_prologue", stage="cm", table_ii=False)
def _ag_prologue(comm, x, *, axis, block_fn=None):
    """Ring all-gather with a fused per-block prologue: ``block_fn`` (a map
    of cube tensors) runs on each source block as it arrives. Row-wise
    along ``axis``, it commutes with the concatenation."""
    return _assemble(comm, x, axis, block_fn or (lambda b: b))


@register_algorithm("reduce_scatter", "rs_epilogue", stage="cm",
                    table_ii=False)
def _rs_epilogue(comm, x, *, axis, op="add", tile_fn=None):
    """Ring reduce-scatter with lazily produced tiles: ``tile_fn(t)`` is
    each PE's contribution to output tile ``t`` (an int tensor of shape
    ``cube.dim_sizes``; default: block t of the payload along ``axis``).

    Ring schedule (shifted so member i finishes holding tile i): start
    from tile (me - 1) % g; each of the g - 1 hops forwards the running
    partial and folds in the local contribution to the tile just
    received."""
    g = comm.group_size
    if tile_fn is None:
        n = x.shape[comm.cube.ndim + axis]
        if n % g:
            raise ValueError(f"payload dim of size {n} not divisible by {g}")
        tile_fn = lambda t: take_block(x, t, n // g, axis=axis)  # noqa: E731
    comb = _REDUCERS[op][0]
    me = comm.axis_index(x.device)
    cur = tile_fn((me - 1) % g)
    for s in range(g - 1):
        got = comm.ring_shift(cur)
        cur = comb(got, tile_fn((me - 2 - s) % g))
    return cur


def _payload_bytes(comm, x) -> int:
    return int(math.prod(x.shape[comm.cube.ndim:])) * _itemsize(x.dtype)


def dispatch_fused(comm, primitive, flow, x, *, payload_bytes=None,
                   **kwargs):
    """Dispatch a compute-fused registry flow eagerly, recording the
    planner-estimated :class:`~repro_torch.core.comm.CommEvent` a plain
    dispatch records (callable-carrying flows are never recorded into a
    program). ``x`` may be a tuple of cube tensors (ring attention rotates
    the ``(k, v)`` pair); payload accounting sums them unless
    ``payload_bytes`` overrides it (a lazy-tile epilogue's logical buffer
    never exists, so its wrapper supplies the bytes)."""
    spec = get_algorithm(primitive, flow)
    if payload_bytes is None:
        leaves = x if isinstance(x, tuple) else (x,)
        payload_bytes = sum(_payload_bytes(comm, t) for t in leaves)
    if _TRACES:
        from repro_torch.core import planner
        est = planner.estimate(comm.cube, primitive, comm.dims,
                               payload_bytes, algorithm=flow)
        event = CommEvent(
            primitive=primitive, bitmap=comm.bitmap, dims=comm.dims,
            algorithm=flow, flow=flow, stage=spec.stage,
            group_size=comm.group_size, num_instances=comm.num_instances,
            payload_bytes=payload_bytes, ici_bytes=est.ici_bytes,
            dcn_bytes=est.dcn_bytes, seconds=est.seconds,
            est_source=est.est_source)
        for t in _TRACES:
            t.record(event)
    return spec.fn(comm, x, **kwargs)
