"""Backward-overlapped gradient sync: fire bucket programs *during* backward.

The counterpart of ``repro.runtime.overlap``. The barrier path
(``runtime.trainer.sync_replicated_grads``) runs the backward to its end and
then one coalesced grad-sync program. This module moves the sync into the
backward:

  bucketing
      Gradient leaves are partitioned into reverse-layer-ordered buckets by
      the top-level parameter group that produces them last during
      backward: the loss head (``lm_head`` / ``final_norm``) first, the
      trunk stack (``units``) next, the input embeddings last. The trunk's
      stacked leaves are unbound once per step (``Model.trunk``), so every
      per-layer gradient of the stack lands together, as the reference's
      scanned stack does.

  firing during backward (``BackwardBucketSync``)
      A multi-grad hook (``torch.autograd.graph.register_multi_grad_hook``)
      over each bucket's view leaves records the bucket's all-reduces as one
      ``CommProgram`` (``grad-sync-b{k}``) and dispatches it with
      ``execute_async`` the moment autograd has produced the bucket's last
      gradient; the rest of the backward is issued after it. The synced
      gradients are held by the hook object (``grads()``); the leaves'
      ``.grad`` keep the unsynced partials.

  double-buffered staging (``sync_replicated_grads_overlapped``)
      The post-backward path for callers that hold the whole gradient tree
      pipelines bucket programs through ``ProgramExecution.stage()``: bucket
      k + 1's coalesced payload is concatenated before bucket k's
      collective is forced.

Both are bit-identical to the barrier sync: every leaf still gets a sum over
exactly its replication dims, and a sum of concatenated leaves is the
concatenation of per-leaf sums, whichever bucket a leaf lands in.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import flat_leaves, leaves, unflatten
from repro_torch.runtime.trainer import replication_dims

# Top-level parameter groups in *forward* production order; backward
# produces their gradients in reverse, which is the bucket dispatch order.
# Unknown groups ride with the trunk (middle of the pipeline).
FORWARD_STAGES: tuple[tuple[str, ...], ...] = (
    ("embed", "frontend_proj"),            # inputs: backward reaches last
    ("enc_units", "enc_final_norm"),       # encoder tower (enc-dec models)
    ("units",),                            # decoder/trunk stack
    ("lm_head", "final_norm"),             # loss head: first grads out
)
_TRUNK_STAGE = 2


def _stage_of(key: str) -> int:
    for rank, names in enumerate(FORWARD_STAGES):
        if key in names:
            return rank
    return _TRUNK_STAGE


def bucket_leaf_indices(tree: dict) -> list[list[int]]:
    """Partition ``tree``'s flat-leaf indices (sorted-key order, as
    ``jax.tree.flatten`` orders the reference's dicts) into reverse-layer-
    ordered buckets: index 0 is the loss-head bucket, the last the
    embedding bucket. Leaf order inside a bucket follows flattening order.
    Empty buckets are dropped."""
    by_stage: dict[int, list[int]] = {}
    for i, (path, _) in enumerate(leaves(tree)):
        by_stage.setdefault(_stage_of(path[0] if path else ""), []).append(i)
    return [by_stage[s] for s in sorted(by_stage, reverse=True)]


def _record_bucket(flat, sflat, idxs, cube, name):
    """Record one bucket's replicated-leaf all-reduces as a CommProgram.
    Returns ``(prog, deferred)``: the flat indices routed through the
    program, in output order (sharded leaves need no reduction)."""
    prog = cube.program(name=name)
    deferred: list[int] = []
    with prog:
        vals = []
        for i in idxs:
            missing = replication_dims(sflat[i], cube)
            if not missing:
                continue
            vals.append(cube.comm(missing).all_reduce(flat[i]))
            deferred.append(i)
        prog.output(*vals)
    return prog, deferred


def _scatter_results(out, deferred, results) -> None:
    if len(deferred) == 1:
        results = (results,)
    for i, r in zip(deferred, results):
        out[i] = r


class BackwardBucketSync:
    """Hooks over the view leaves ``params`` (a tree of tensors that
    require grad): during the next backward, each bucket with a replicated
    leaf records and dispatches its ``grad-sync-b{k}`` program as soon as
    its last gradient is computed. ``fired`` lists the bucket programs in
    dispatch order; ``grads()`` returns the synced gradient tree."""

    def __init__(self, params: dict, specs: dict, cube):
        self.params = params
        self.cube = cube
        self.flat = flat_leaves(params)
        self.sflat = flat_leaves(specs)
        self.synced: dict[int, torch.Tensor] = {}
        self.fired: list[str] = []
        self.handles = []
        buckets = [idxs for idxs in bucket_leaf_indices(params)
                   if any(replication_dims(self.sflat[i], cube)
                          for i in idxs)]
        self.n_buckets = len(buckets)
        for k, idxs in enumerate(buckets):
            self.handles.append(torch.autograd.graph.register_multi_grad_hook(
                [self.flat[i] for i in idxs],
                self._hook(idxs, f"grad-sync-b{k}"), mode="all"))

    def _hook(self, idxs, name):
        def fire(grads):
            flat = dict(zip(idxs, grads))
            prog, deferred = _record_bucket(flat, self.sflat, idxs,
                                            self.cube, name)
            if deferred:
                ex = prog.execute_async()
                ex.stage()              # concat the bucket before the wire op
                out: dict = {}
                _scatter_results(out, deferred, ex.outputs())
                self.synced.update(out)
            self.fired.append(name)
        return fire

    def grads(self) -> dict:
        """The gradient tree after the backward: the synced sums for the
        replicated leaves, ``.grad`` for the rest. Removes the hooks."""
        for h in self.handles:
            h.remove()
        self.handles = []
        if len(self.fired) != self.n_buckets:
            raise RuntimeError(
                f"backward fired {self.fired} of {self.n_buckets} grad-sync "
                "buckets")
        return unflatten(self.params, [
            self.synced.get(i, p.grad) for i, p in enumerate(self.flat)])


def with_backward_bucket_sync(loss_fn, specs: dict, cube):
    """Wrap ``loss_fn(params, *rest)``: the wrapper installs a
    ``BackwardBucketSync`` on ``params`` (view leaves) and returns
    ``(loss_fn(params, *rest), sync)``; after the caller's backward,
    ``sync.grads()`` is the gradient tree already synced over each leaf's
    replication dims, bit-identical to ``sync_replicated_grads``."""
    def wrapped(params, *rest):
        sync = BackwardBucketSync(params, specs, cube)
        return loss_fn(params, *rest), sync
    return wrapped


def sync_replicated_grads_overlapped(grads: dict, specs: dict, cube) -> dict:
    """Post-backward bucketed dispatch, for callers that hold the whole
    gradient tree: one program per reverse-layer bucket, pipelined double-
    buffered (bucket k + 1 staged before bucket k's collective is forced).
    Bit-identical to ``sync_replicated_grads``."""
    flat = flat_leaves(grads)
    sflat = flat_leaves(specs)
    out = list(flat)
    recorded = []
    for idxs in bucket_leaf_indices(grads):
        prog, deferred = _record_bucket(
            flat, sflat, idxs, cube, f"grad-sync-b{len(recorded)}")
        if deferred:
            recorded.append((prog, deferred))
    execs = [prog.execute_async() for prog, _ in recorded]
    if execs:
        execs[0].stage()
    for k, (ex, (_, deferred)) in enumerate(zip(execs, recorded)):
        if k + 1 < len(execs):
            execs[k + 1].stage()        # double-buffer: stage the next
        _scatter_results(out, deferred, ex.outputs())  # ...force this one
    return unflatten(grads, out)
