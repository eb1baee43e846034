"""Topology-bound checkpoint manager: async save, elastic restore.

The counterpart of ``repro.checkpoint.manager``. Placement is bound once at
construction::

    mgr = CheckpointManager(root, topo=topo, specs={"params": pspecs,
                                                    "opt": ospecs})
    mgr.save(step, TrainState(params=masters, opt=opt_state))
    state = mgr.restore(step)                       # onto mgr's topology
    params = mgr.restore_params(step, serve_topo=stopo, specs=sspecs)

The state tree is one :class:`TrainState`. The reference's positional
signatures -- ``save(step, params, opt_state)``, ``restore(step,
params_like, opt_like, topo=..., param_specs=..., opt_specs=...)`` and
``restore_params(step, params_like, topo=..., param_specs=...)`` -- keep
working as deprecated shims (``DeprecationWarning``); a ``like`` skeleton
holds global-shaped leaves.

Files always hold the reference's global arrays, so a checkpoint written
here restores in the JAX package and the other way round. With a topology
the leaves are cube tensors and move through collective programs
(:mod:`repro_torch.checkpoint.reshard`): save records one rooted-gather
program per section, restore one rooted-scatter program per section. A
manager with no topology reads and writes global tensors; ``save`` then
takes ``topo=`` / ``specs=`` for a state of cube tensors (the ``Trainer``
passes its own), and restore places on ``device`` (CUDA unless the CPU is
asked for).

**Async save** splits where the reference splits it: the gather programs
run at ``save()`` dispatch -- the train step updates the masters and the
int8 moments in place, so the device->host copy must finish before the
next step runs -- while serialization and disk writes run on a bounded
background executor (``checkpoint:{section}`` spans, ``ckpt.*``
metrics). Worker failures are re-raised at ``wait()`` or the next
``save()``, each exactly once. Every file is synced to the disk
(``checkpoint-durable`` means on the disk, not in the page cache), and the
manifest is written and the ``.tmp`` directory renamed only after every
section landed, so a checkpoint killed mid-write -- or lost to a crash --
is invisible to ``all_steps()`` / ``restore()`` and the retry overwrites
it.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import layout, reshard
from repro_torch.telemetry import metrics as _telemetry
from repro_torch.telemetry import spans as _spans


@dataclasses.dataclass
class TrainState:
    """The checkpointed unit: model params plus optimizer state, one tree."""
    params: Any
    opt: Any = None


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} (topology-bound CheckpointManager "
        "surface)", DeprecationWarning, stacklevel=3)


def _host_array(leaf, path, *, copy: bool = True) -> np.ndarray:
    """A global leaf (tensor, array or scalar) as a NumPy array, a copy of
    its own unless ``copy=False`` says it is one already: the caller may
    update the leaf in place once ``save()`` returns."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(
                f"checkpoint leaf {'/'.join(map(str, path))} is bfloat16, "
                "which has no NumPy dtype here; keep checkpointed state in "
                "f32 / int8 / int32")
        return leaf.detach().to("cpu", copy=copy).numpy()
    return np.array(leaf, dtype=layout.dtype_name(leaf), copy=copy)


class CheckpointManager:
    """Sharded, atomic, async-capable checkpointing with elastic restore.

    Parameters
    ----------
    root:
        Checkpoint directory (one ``step_<n>`` subdirectory per step).
    topo:
        The topology (or bare Hypercube) whose cube save gathers from and
        restore scatters onto. ``None``: leaves are global tensors, written
        as they are and restored onto ``device``.
    specs:
        ``{"params": ..., "opt": ...}`` (or TrainState-shaped) tree of spec
        tuples: the layout of each leaf on ``topo``'s cube.
    keep_last:
        GC horizon: completed checkpoints beyond the newest ``keep_last``
        are deleted after each successful save. The step being written is
        never collected.
    max_workers:
        Bound on the background write executor.
    device:
        Where restore places (default CUDA; ``"cpu"`` to run there).
    """

    def __init__(self, root: str, *, topo=None, specs=None,
                 async_save: bool = True, keep_last: int = 3,
                 max_workers: int = 2, device=None):
        self.root = root
        self.topo = topo
        self.specs = specs
        self.async_save = async_save
        self.keep_last = keep_last
        self.max_workers = max(1, int(max_workers))
        self.device = device
        self._executor: ThreadPoolExecutor | None = None
        self._pending: list[Future] = []
        self._writing: set[int] = set()
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------ io
    def _dir(self, step: int) -> str:
        return layout.step_dir(self.root, step)

    def _ensure_executor(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self.max_workers,
                thread_name_prefix="ckpt-write")
        return self._executor

    def _specs_sections(self) -> dict | None:
        return _sections_of(self.specs) if self.specs is not None else None

    # ---------------------------------------------------------------- save
    def save(self, step: int, state, opt_state=None, *,
             extra: dict | None = None, topo=None, specs=None) -> None:
        """Write ``state`` (a :class:`TrainState`) as checkpoint ``step``.

        Gathers to host via one rooted-gather program per section at
        dispatch, then (``async_save``) hands serialization and the atomic
        rename to the background executor. ``topo`` / ``specs`` lay out a
        state of cube tensors where the manager has no bound topology. The
        deprecated form ``save(step, params, opt_state)`` still works.
        """
        if opt_state is not None or not isinstance(state, TrainState):
            _deprecated("save(step, params, opt_state)",
                        "save(step, TrainState(params=..., opt=...))")
            state = TrainState(params=state, opt=opt_state)
        if self.topo is not None:
            topo, specs = self.topo, self._specs_sections()
        elif specs is not None:
            specs = _sections_of(specs)
        if topo is not None and specs is None:
            raise ValueError("a save through a topology needs its specs")
        self.wait()  # one save in flight; re-raises captured write errors
        t0 = time.monotonic()
        _telemetry.inc("ckpt.saves")

        flat = list(layout.flatten({"opt": state.opt,
                                    "params": state.params}))
        paths = [p for p, _ in flat]
        leaves = [leaf for _, leaf in flat]
        n_opt = sum(1 for p in paths if p[0] == "opt")

        # device -> host: one recorded rooted-gather program per section.
        # Its structural fingerprint is step-invariant, so it lowers once
        # and then hits the cube's lower cache every save. Runs at dispatch
        # because the train step updates these tensors in place.
        sections = {"opt": (0, n_opt), "params": (n_opt, len(leaves))}
        host: list = [None] * len(leaves)
        for name, (lo, hi) in sections.items():
            if hi == lo:
                continue
            with _spans.maybe_span(f"checkpoint:gather:{name}", cat="wall",
                                   step=step, leaves=hi - lo):
                if topo is not None:
                    # the gather's outputs are host copies of their own
                    host[lo:hi] = [_host_array(t, p, copy=False) for t, p in
                                   zip(reshard.gather_to_host(
                                       topo, leaves[lo:hi],
                                       _section_spec_leaves(specs, name,
                                                            hi - lo),
                                       name=f"ckpt-gather-{name}"),
                                       paths[lo:hi])]
                else:
                    host[lo:hi] = [_host_array(t, p)
                                   for t, p in zip(leaves[lo:hi],
                                                   paths[lo:hi])]
        records = layout.leaf_records(layout.tree_from_paths(paths, host))
        cube = getattr(topo, "cube", topo)
        manifest = layout.build_manifest(
            step, records, n_opt=n_opt,
            cube_dims=(dict(zip(cube.dim_names, cube.dim_sizes))
                       if cube is not None else None),
            extra=extra)

        tmp = self._dir(step) + ".tmp"
        if os.path.exists(tmp):  # debris from a killed writer: retry wins
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        self._writing.add(step)

        def write_section(name: str, lo: int, hi: int) -> int:
            with _spans.maybe_span(f"checkpoint:{name}", cat="wall",
                                   step=step, leaves=hi - lo):
                nbytes = 0
                for i in range(lo, hi):
                    with open(os.path.join(tmp, f"arr_{i}.npy"), "wb") as f:
                        np.save(f, host[i])
                        layout.sync_file(f)
                    nbytes += host[i].nbytes
            return nbytes

        def finalize(section_bytes: list[int]) -> None:
            try:
                layout.write_manifest(tmp, manifest)
                layout.atomic_finalize(tmp, self._dir(step))
                total = int(sum(section_bytes))
                _telemetry.set_gauge("ckpt.saved_bytes", total)
                _telemetry.observe("ckpt.save_seconds",
                                   time.monotonic() - t0)
                _spans.maybe_instant("checkpoint-durable", step=step,
                                     bytes=total)
            finally:
                self._writing.discard(step)
            self._gc(protect={step})

        spans = [(name, lo, hi) for name, (lo, hi) in sections.items()
                 if hi > lo]
        if self.async_save:
            ex = self._ensure_executor()
            futs = [ex.submit(write_section, *s) for s in spans]

            def run_finalize(section_futs=tuple(futs)):
                # FIFO executor: the sections queued above finish (or fail)
                # before this task reads their results, so it never blocks
                # a worker on a task behind it in the queue
                finalize([f.result() for f in section_futs])

            self._pending = futs + [ex.submit(run_finalize)]
        else:
            try:
                finalize([write_section(*s) for s in spans])
            finally:
                self._writing.discard(step)

    def wait(self) -> None:
        """Block until the in-flight save is durable; re-raise the first
        captured write error (each error is surfaced exactly once)."""
        pending, self._pending = self._pending, []
        errors: list[BaseException] = []
        for f in pending:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if all(e is not seen for seen in errors):
                    errors.append(e)
        if errors:
            _telemetry.inc("ckpt.write_errors", len(errors))
            raise errors[0]

    def _gc(self, *, protect: set[int] = frozenset()) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.keep_last:]) if self.keep_last > 0 \
            else set(steps)
        for s in steps:
            if s in keep or s in protect or s in self._writing:
                continue
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def all_steps(self) -> list[int]:
        return layout.list_steps(self.root)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- restore
    def restore(self, step: int, params_like=None, opt_like=None, *,
                topo=None, param_specs=None, opt_specs=None):
        """Restore checkpoint ``step``.

        ``restore(step)`` returns a :class:`TrainState` placed on the
        manager's bound topology under its bound specs (structure from the
        specs tree, else the manifest's leaf records): cube tensors, which
        ``runtime.trainer.resume_state`` turns into the trainer's compact
        state; with no topology, global tensors.

        Deprecated shim: ``restore(step, params_like, opt_like, ...)``
        returns the old ``(params, opt)`` tuple.
        """
        if params_like is not None:
            _deprecated("restore(step, params_like, opt_like)",
                        "restore(step)")
            like = {"opt": opt_like, "params": params_like}
            specs = None
            if topo is not None and param_specs is not None:
                specs = {"opt": opt_specs, "params": param_specs}
            state = self._restore_state(step, like=like, specs=specs,
                                        topo=topo)
            return state.params, state.opt
        return self._restore_state(step, like=None,
                                   specs=self._specs_sections(),
                                   topo=self.topo)

    def restore_params(self, step: int, params_like=None, *,
                       serve_topo=None, specs=None, topo=None,
                       param_specs=None):
        """Restore **params only** -- the restore-for-serving path.

        ``restore_params(step, serve_topo=stopo, specs=sspecs)`` places the
        params section onto the serve topology (default: the manager's
        bound topology and specs). Elastic: the serve cube may have other
        dims than the cube that saved.

        Deprecated shim: ``restore_params(step, params_like, topo=...,
        param_specs=...)``.
        """
        if params_like is not None:
            _deprecated("restore_params(step, params_like)",
                        "restore_params(step, serve_topo=..., specs=...)")
            serve_topo, specs = topo, param_specs
            like = params_like
        else:
            like = None
            if serve_topo is None:
                serve_topo = self.topo
            if specs is None:
                bound = self._specs_sections()
                specs = bound["params"] if bound else None
        return self._restore_section(step, "params", like=like,
                                     specs=specs, topo=serve_topo)

    # ------------------------------------------------------ restore internals
    def _load_manifest(self, step: int) -> dict:
        d = self._dir(step)
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.root} "
                f"(have steps {self.all_steps()})")
        return layout.read_manifest(d)

    def _load(self, step: int, lo: int, hi: int) -> list[np.ndarray]:
        d = self._dir(step)
        return [np.load(os.path.join(d, f"arr_{i}.npy"))
                for i in range(lo, hi)]

    def _finish_restore(self, host: list[np.ndarray], t0: float) -> None:
        _telemetry.inc("ckpt.restores")
        _telemetry.set_gauge("ckpt.restored_bytes",
                             int(sum(a.nbytes for a in host)))
        _telemetry.observe("ckpt.restore_seconds", time.monotonic() - t0)

    def _restore_state(self, step: int, *, like, specs, topo) -> TrainState:
        self.wait()
        t0 = time.monotonic()
        manifest = self._load_manifest(step)
        n_leaves = int(manifest["n_leaves"])
        n_opt = int(manifest["sections"]["opt"])
        records = manifest.get("leaves")

        if like is not None:
            paths = [p for p, _ in layout.flatten(like)]
            if records is not None:
                layout.validate_records(records, layout.leaf_records(like),
                                        section="state", step=step)
            elif len(paths) != n_leaves:
                raise ValueError(
                    f"checkpoint step {step} holds {n_leaves} state leaves "
                    f"but the target structure has {len(paths)} -- "
                    "architecture mismatch between save and restore")
        elif specs is not None:
            paths = [p for p, _ in layout.flatten(_sections_of(specs))]
            if len(paths) != n_leaves:
                raise ValueError(
                    f"checkpoint step {step} holds {n_leaves} state leaves "
                    f"but the bound specs tree has {len(paths)} -- "
                    "architecture mismatch between save and restore")
        elif records is not None:
            paths = [r["path"] for r in records]
        else:
            raise ValueError(
                "checkpoint manifest predates leaf records; pass specs= to "
                "CheckpointManager or use the deprecated "
                "restore(step, params_like, opt_like) form")

        host = self._load(step, 0, n_leaves)
        placed: list[Any] = [None] * n_leaves
        for name, lo, hi in (("opt", 0, n_opt),
                             ("params", n_opt, n_leaves)):
            if hi == lo:
                continue
            sec_specs = (_section_spec_leaves(_sections_of(specs), name,
                                              hi - lo)
                         if specs is not None else None)
            placed[lo:hi] = self._place(host[lo:hi], sec_specs, topo,
                                        section=name)
        tree = layout.tree_from_paths(paths, placed)
        self._finish_restore(host, t0)
        return TrainState(params=tree["params"], opt=tree.get("opt"))

    def _restore_section(self, step: int, section: str, *, like, specs,
                         topo):
        self.wait()
        t0 = time.monotonic()
        manifest = self._load_manifest(step)
        n_leaves = int(manifest["n_leaves"])
        sections = manifest.get("sections")
        records = manifest.get("leaves")

        if like is not None:
            paths = [p for p, _ in layout.flatten(like)]
        elif specs is not None:
            paths = [p for p, _ in layout.flatten(specs)]
        elif records is not None:
            n = sections[section]
            offset0 = n_leaves - sections["params"] \
                if section == "params" else 0
            # record paths are rooted at the full state tree; drop the
            # leading section key so the rebuilt tree is the bare section
            paths = [list(r["path"])[1:]
                     for r in records[offset0:offset0 + n]]
        else:
            raise ValueError(
                "checkpoint manifest predates leaf records; pass specs= or "
                "the deprecated params_like skeleton")

        n = len(paths)
        n_section = sections[section] if sections else n
        if n_section != n:
            raise ValueError(
                f"checkpoint step {step} holds {n_section} {section} leaves "
                f"but the target structure has {n} -- architecture "
                "mismatch between save and restore")
        # params leaves are the trailing section of the flat order
        # ("params" sorts after "opt" in the save-time flatten)
        offset = (n_leaves - n_section) if section == "params" else 0
        if records is not None and like is not None:
            sec = [{**r, "path": list(r["path"])[1:]}
                   for r in records[offset:offset + n_section]]
            layout.validate_records(sec, layout.leaf_records(like),
                                    section=section, step=step)

        host = self._load(step, offset, offset + n_section)
        spec_leaves = reshard.flatten_specs(specs, len(host)) \
            if specs is not None else None
        out = self._place(host, spec_leaves, topo, section=section)
        self._finish_restore(host, t0)
        return layout.tree_from_paths(paths, out)

    def _place(self, host: list[np.ndarray], spec_leaves, topo, *,
               section: str) -> list:
        """Host arrays -> tensors: one rooted-scatter program per section
        when placement is known, global tensors on the device otherwise."""
        device = resolve_device(self.device)
        tensors = [torch.from_numpy(a) for a in host]
        if topo is not None and spec_leaves is not None:
            with _spans.maybe_span(f"checkpoint:restore:{section}",
                                   cat="wall", leaves=len(host)):
                return reshard.scatter_to_cube(
                    topo, tensors, spec_leaves,
                    name=f"ckpt-restore-{section}", device=device)
        return [t.to(device) for t in tensors]


def _sections_of(tree) -> dict:
    """Normalize a TrainState / {"params", "opt"} dict into sections."""
    if isinstance(tree, TrainState):
        return {"opt": tree.opt, "params": tree.params}
    if isinstance(tree, dict) and "params" in tree \
            and set(tree) <= {"opt", "params"}:
        return {"opt": tree.get("opt"), "params": tree["params"]}
    raise TypeError(
        "expected a TrainState or a {'params': ..., 'opt': ...} dict, got "
        f"{type(tree).__name__}")


def _section_spec_leaves(specs: dict, section: str, n: int) -> list:
    """Flat spec leaves of one section of a sections dict (``None`` node:
    no leaves)."""
    flat = [tuple(s) for _, s in layout.flatten(specs.get(section))]
    if len(flat) != n:
        raise ValueError(
            f"{section} spec tree has {len(flat)} leaves, checkpoint "
            f"section has {n}")
    return flat


__all__ = ["CheckpointManager", "TrainState"]
