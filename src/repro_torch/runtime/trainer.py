"""The train step on the in-process cube and the training loop driver.

The counterpart of ``repro.runtime.trainer``. One step:

  forward + backward of ``Model.loss_shard`` on per-step view leaves of the
  compact master weights (FSDP all_gathers, TP all_gathers /
  reduce_scatters through topology-bound communicators, ``algorithm=
  "auto"``) -> the replicated-gradient all-reduces, recorded as one
  ``CommProgram`` (or one per reverse-layer bucket, fired from autograd
  hooks during the backward: ``runtime.overlap``), optionally the int8 §V-C
  pod hop with error feedback -> the replication-aware global-norm clip ->
  AdamW (8-bit moments) on the compact masters.

The cube holds every PE's tensor in one process. A master weight is the
compact tensor ``Hypercube.place`` lays out (size 1 on the dims its spec
does not name: ``models.params.trainable``). The model reads a view of it
over the whole cube that is a leaf of its own (``view_leaves``), so each
PE's use of a replicated weight leaves its own partial gradient, as a
shard of the reference's shard_map does; differentiating through the
broadcast itself would let autograd sum the replicas, and the grad-sync
program would have nothing to do. The program sums the partials over each
leaf's replication dims through PID-Comm; index 0 of those dims is the
compact gradient.

The backward starts from the mean of the cube's copies of the loss (every
PE holds the same value; their sum would count it once per PE).

The port always takes the reference's explicit (pre-vma) sync path:
autograd here inserts no collective. The loop driver adds per-step
deadlines (straggler counting), telemetry and checkpoints
(``repro_torch.checkpoint``): every ``checkpoint_every`` steps it saves
``TrainState(params=masters, opt=opt_state)``, and ``resume_state`` turns a
restored state back into the step's compact layout.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from repro_torch.core.comm import CommTrace
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    compact, flat_leaves, get_path, leaves, param_defs, param_specs,
    trainable, tree_map, unflatten)
from repro_torch.models.topology import Topology
from repro_torch.optim import adamw
from repro_torch.telemetry import metrics as _telemetry
from repro_torch.telemetry import spans as _spans


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()
    # int8 DCN gradient hop (paper §V-C): pod-crossing replicated-gradient
    # all-reduces dispatch the registry's "compressed" flow
    compress_pod_grads: bool = False
    # error feedback for the compressed hop: each leaf's int8 residual
    # persists in opt_state["ef"] and is folded into the next step's
    # gradient (only with compress_pod_grads on a DCN-crossing cube)
    error_feedback: bool = True
    # backward-overlapped gradient sync: bucket the replicated-leaf
    # all-reduces by reverse-layer order and fire each bucket's program from
    # an autograd hook during the backward (runtime.overlap), instead of one
    # barrier program after it; bit-identical. Not with compressed pod
    # gradients (blockwise int8 quantization is bucketing-sensitive).
    overlap_grad_sync: bool = True
    step_deadline_s: float = 0.0       # 0 = no straggler deadline
    # run the step as timed phases (forward / forward+backward / sync /
    # clip+opt) into the train.*_seconds histograms; the forward runs once
    # more for attribution, so this is a diagnostics mode
    telemetry_split: bool = False


def _spec_axes(spec) -> set:
    """Cube dims a spec shards over."""
    present = set()
    for entry in tuple(spec):
        if entry is None:
            continue
        present.update((entry,) if isinstance(entry, str) else entry)
    return present


def _replication_factor(spec, cube) -> int:
    present = _spec_axes(spec)
    return math.prod(n for d, n in zip(cube.dim_names, cube.dim_sizes)
                     if d not in present)


def replication_dims(spec, cube) -> tuple[str, ...]:
    """Cube dims a leaf with ``spec`` is replicated over (size > 1)."""
    present = _spec_axes(spec)
    return tuple(d for d, n in zip(cube.dim_names, cube.dim_sizes)
                 if d not in present and n > 1)


def view_leaves(masters: dict, cube) -> dict:
    """The model's per-step parameters: each compact master broadcast over
    the whole cube, detached, as a leaf that requires grad. Its ``.grad``
    is per PE: a replicated block's copies get their own partials."""
    return tree_map(
        lambda m: m.expand(cube.dim_sizes + tuple(m.shape[cube.ndim:]))
        .detach().requires_grad_(), masters)


def sync_replicated_grads(grads: dict, specs: dict, cube, *,
                          compress_pod: bool = False, ef=None):
    """Sum each per-PE gradient over its replication dims: sharded compute
    feeding a replicated parameter leaves one partial per PE.

    The per-leaf all-reduces are recorded into one ``CommProgram`` named
    ``grad-sync``: lowering coalesces the small same-group all-reduces into
    bucketed dispatches, and its structure is the same every step, so
    every step after the first hits the lower cache. Each dispatch runs
    ``algorithm="auto"`` through the registry. With ``compress_pod`` the
    DCN-crossing reductions take the "compressed" int8 flow; ``ef`` (flat
    leaf index as a string -> error buffer, ``init_error_feedback``) threads
    the compressed hop's quantization error across steps, and the call then
    returns ``(synced, new_ef)``."""
    flat = flat_leaves(grads)
    sflat = flat_leaves(specs)
    cn = cube.ndim
    out: list = [None] * len(flat)
    new_ef = dict(ef) if ef is not None else None
    deferred: list = []                 # (leaf index, ProgramValue)
    prog = cube.program(name="grad-sync")
    with prog:
        for i, (g, s) in enumerate(zip(flat, sflat)):
            missing = replication_dims(s, cube)
            if not missing:
                out[i] = g
                continue
            comm = cube.comm(missing)
            if compress_pod and comm.crosses_dcn:
                if new_ef is not None and str(i) in new_ef:
                    # eager two-output flow: correct by the carried error,
                    # keep the fresh quantization residual
                    red, err = comm.all_reduce_with_error(
                        g.float(), error=new_ef[str(i)].squeeze(cn))
                    out[i] = red.to(g.dtype)
                    new_ef[str(i)] = err.unsqueeze(cn)
                else:
                    deferred.append(
                        (i, comm.all_reduce(g, algorithm="compressed")))
            else:
                deferred.append((i, comm.all_reduce(g)))
        prog.output(*(v for _, v in deferred))
    if deferred:
        results = prog.execute()
        if len(deferred) == 1:
            results = (results,)
        for (i, _), r in zip(deferred, results):
            out[i] = r
    synced = unflatten(grads, out)
    return synced if ef is None else (synced, new_ef)


def init_error_feedback(params: dict, specs: dict, cube) -> dict:
    """Zero error-feedback buffers for the §V-C compressed gradient hop: one
    per leaf whose replication dims cross DCN, keyed by flat leaf index (a
    string). A buffer is per PE, ``(*cube, 1, *local)``: the cube tensor of
    the reference's global ``(n_slow, *leaf.shape)`` array under
    ``(dcn_dims, *spec)`` (``error_feedback_specs``). The error is the same
    within a pod's ICI group and differs across pods, so the pod axis is
    materialized and a checkpoint keeps every pod's buffer."""
    out = {}
    for i, (p, s) in enumerate(zip(flat_leaves(params), flat_leaves(specs))):
        missing = replication_dims(s, cube)
        if missing and any(d in cube.dcn_dims for d in missing):
            out[str(i)] = torch.zeros(
                cube.dim_sizes + (1,) + tuple(p.shape[cube.ndim:]),
                dtype=torch.float32, device=p.device)
    return out


def error_feedback_specs(cfg: ModelConfig, topo: Topology) -> dict:
    """Specs of ``init_error_feedback``'s buffers: each leaf's spec behind
    the cube's DCN dims (the reference's ``P(dcn_dims, *spec)``)."""
    cube = topo.cube
    return {str(i): (cube.dcn_dims,) + tuple(s)
            for i, s in enumerate(flat_leaves(param_specs(cfg, topo)))
            if any(d in cube.dcn_dims for d in replication_dims(s, cube))}


def use_error_feedback(tc: TrainConfig, cube) -> bool:
    """Whether this run threads an error-feedback buffer through opt_state:
    compressed pod gradients asked for, and the cube crosses DCN."""
    return bool(tc.compress_pod_grads and tc.error_feedback and cube.dcn_dims)


def input_batch_specs(cfg: ModelConfig, topo: Topology) -> dict:
    dp = topo.dp
    specs = {"tokens": (dp, None), "labels": (dp, None)}
    if cfg.frontend == "patch":
        specs["patches"] = (dp, None, None)
    if cfg.is_encoder_decoder:
        specs["frames"] = (dp, None, None)
    return specs


def place_batch(batch: dict, cfg: ModelConfig, topo: Topology,
                device) -> dict:
    """A global batch (NumPy arrays or tensors, ``TokenStream`` layout) on
    the cube under ``input_batch_specs``; token ids as int64."""
    specs = input_batch_specs(cfg, topo)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        if not t.is_floating_point():
            t = t.long()
        out[k] = topo.cube.to_cube(t, specs[k])
    return out


def _clip(grads: dict, specs: dict, cube, clip_norm: float):
    """Replication-aware global-norm clip: each PE's sum of squares, each
    leaf divided by its replication degree, summed over the whole cube by
    one all-reduce. Returns (scale (*cube), grad norm (*cube))."""
    cn = cube.ndim
    sq = torch.zeros(cube.dim_sizes, dtype=torch.float32,
                     device=flat_leaves(grads)[0].device)
    for g, s in zip(flat_leaves(grads), flat_leaves(specs)):
        part = g.float().square().sum(dim=tuple(range(cn, g.dim())))
        sq = sq + part / _replication_factor(s, cube)
    gnorm = torch.sqrt(cube.comm(cube.dim_names).all_reduce(sq))
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    return scale, gnorm


def _apply(masters: dict, opt_state: dict, grads: dict, specs: dict, cube,
           tc: TrainConfig, lr_fn):
    """Clip, keep index 0 of each gradient's replicated dims (the compact
    gradient), AdamW on the compact masters. The gradients are scaled and
    the masters and moments written in place: a full-width model's f32
    tensors are never held twice. Returns (masters, opt_state,
    {"grad_norm", "lr"})."""
    cn = cube.ndim
    scale, gnorm = _clip(grads, specs, cube, tc.clip_norm)

    def compact_grad(g, s):
        sc = scale.reshape(cube.dim_sizes + (1,) * (g.dim() - cn))
        return compact(g, s, cube).mul_(compact(sc, s, cube))

    cgrads = tree_map(compact_grad, grads, specs)
    lr = lr_fn(opt_state["step"])
    ef = opt_state.get("ef")
    masters, new_state = adamw.update(masters, opt_state, cgrads, lr=lr,
                                      cfg=tc.adamw, cube_ndim=cn)
    if ef is not None:
        new_state["ef"] = ef
    return masters, new_state, {"grad_norm": gnorm, "lr": lr}


class _Step:
    """The train step's phases over one (cfg, topology, TrainConfig)."""

    def __init__(self, cfg: ModelConfig, topo: Topology, tc: TrainConfig,
                 dtype: torch.dtype):
        self.cfg, self.topo, self.tc = cfg, topo, tc
        self.model = Model(cfg, topo, dtype=dtype)
        self.specs = param_specs(cfg, topo)
        self.lr_fn = adamw.cosine_schedule(tc.lr, tc.warmup, tc.total_steps)
        self.with_ef = use_error_feedback(tc, topo.cube)
        # the compressed / error-feedback flow keeps the barrier sync
        self.overlap = (tc.overlap_grad_sync and not self.with_ef
                        and not tc.compress_pod_grads)

    def fwd(self, masters, batch):
        with torch.no_grad():
            return self.model.loss_shard(view_leaves(masters, self.topo.cube),
                                         batch)

    def fwd_bwd(self, masters, batch, *, overlap: bool = False):
        """Loss, metrics and per-PE gradients; with ``overlap`` the
        replicated ones come back already synced by the backward's bucket
        hooks."""
        from repro_torch.runtime.overlap import with_backward_bucket_sync
        views = view_leaves(masters, self.topo.cube)
        if overlap:
            (loss, metrics), hooks = with_backward_bucket_sync(
                self.model.loss_shard, self.specs, self.topo.cube)(views,
                                                                   batch)
        else:
            loss, metrics = self.model.loss_shard(views, batch)
        loss.mean().backward()
        grads = (hooks.grads() if overlap
                 else tree_map(lambda v: v.grad, views))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def sync(self, grads, opt_state):
        if self.with_ef:
            grads, opt_state["ef"] = sync_replicated_grads(
                grads, self.specs, self.topo.cube, compress_pod=True,
                ef=opt_state["ef"])
            return grads
        return sync_replicated_grads(grads, self.specs, self.topo.cube,
                                     compress_pod=self.tc.compress_pod_grads)

    def opt(self, masters, opt_state, grads):
        return _apply(masters, opt_state, grads, self.specs, self.topo.cube,
                      self.tc, self.lr_fn)

    def __call__(self, masters, opt_state, batch):
        opt_state = dict(opt_state)
        loss, metrics, grads = self.fwd_bwd(masters, batch,
                                            overlap=self.overlap)
        if not self.overlap:
            grads = self.sync(grads, opt_state)
        masters, opt_state, om = self.opt(masters, opt_state, grads)
        return masters, opt_state, dict(metrics, loss=loss, **om)


def make_train_step(cfg: ModelConfig, topo: Topology, tc: TrainConfig, *,
                    dtype: torch.dtype = torch.bfloat16):
    """The step ``(masters, opt_state, batch) -> (masters, opt_state,
    metrics)``: masters are compact (``models.params.trainable``), the
    batch is on the cube (``place_batch``), metrics are (*cube) tensors
    ("ce_loss", "aux_loss", "tokens", "loss", "grad_norm"; "lr" 0-d).
    ``dtype`` is the compute dtype over the f32 masters."""
    return _Step(cfg, topo, tc, dtype)


def make_split_train_step(cfg: ModelConfig, topo: Topology,
                          tc: TrainConfig, *,
                          dtype: torch.dtype = torch.bfloat16):
    """The step as separate phases, for the telemetry step-time split
    (``TrainConfig.telemetry_split``). Returns ``(fwd, fwd_bwd, sync,
    opt)``: ``fwd(masters, batch) -> (loss, aux)``; ``fwd_bwd(masters,
    batch) -> (loss, aux, grads)``; ``sync(grads, opt_state) -> grads``;
    ``opt(masters, opt_state, grads) -> (masters, opt_state, metrics)``.
    Plain sync path only."""
    if tc.compress_pod_grads:
        raise ValueError(
            "telemetry_split supports the plain gradient-sync path only "
            "(compress_pod_grads records inside the fused step)")
    step = _Step(cfg, topo, tc, dtype)
    return step.fwd, step.fwd_bwd, step.sync, step.opt


def init_opt_state(params: dict, cfg: ModelConfig, topo: Topology,
                   tc: TrainConfig) -> dict:
    """Optimizer state for ``make_train_step`` over compact masters: AdamW
    moments, plus the compressed hop's error-feedback buffers when this run
    threads them."""
    state = adamw.init_state(params, tc.adamw)
    if use_error_feedback(tc, topo.cube):
        state["ef"] = init_error_feedback(params, param_specs(cfg, topo),
                                          topo.cube)
    return state


def opt_specs(cfg: ModelConfig, topo: Topology, tc: TrainConfig) -> dict:
    """Specs of ``init_opt_state``'s tree -- the opt half of a
    topology-bound ``CheckpointManager``'s ``specs={"params": ...,
    "opt": ...}``: each moment and scale under its parameter's spec, the
    step replicated, an error buffer under ``error_feedback_specs``."""
    sd = adamw.state_defs(param_defs(cfg, topo), tc.adamw, cube=topo.cube)
    mu = tree_map(lambda d: d[1], sd["mu"])
    out = {"mu": mu, "step": ()}
    if use_error_feedback(tc, topo.cube):
        out["ef"] = error_feedback_specs(cfg, topo)
    return out


def resume_state(state, cfg: ModelConfig, topo: Topology,
                 tc: TrainConfig) -> tuple[dict, dict]:
    """``(masters, opt_state)`` for ``make_train_step`` from a
    ``TrainState`` restored onto ``topo`` under ``param_specs`` /
    ``opt_specs`` (cube tensors): compact masters and moments
    (``models.params.trainable``), the 0-d step counter, the error buffers
    as placed. Raises where a moment's per-PE shape is not the one
    ``init_opt_state`` gives on this topology: an int8 scale holds one
    column per shard of its weight's last axis, so a full state saved on a
    layout that shards that axis another number of ways cannot resume here
    (restore the params only)."""
    cube = topo.cube
    ospecs = opt_specs(cfg, topo, tc)
    want = adamw.state_defs(param_defs(cfg, topo), tc.adamw, cube=cube)
    for path, (shape, spec, _) in leaves(want["mu"]):
        got = tuple(get_path(state.opt["mu"], path).shape[cube.ndim:])
        local = cube.local_shape(shape, spec)
        if got != local:
            raise ValueError(
                f"opt/mu/{'/'.join(path)}: restored per-PE shape {got} != "
                f"{local} on {cube.describe()} -- the optimizer state was "
                "saved on a layout that shards this weight's last axis "
                "another number of ways; restore the params only")
    masters = trainable(state.params, param_specs(cfg, topo), cube)
    opt = {"mu": trainable(state.opt["mu"], ospecs["mu"], cube),
           "step": state.opt["step"].reshape(-1)[0].clone()}
    if "ef" in ospecs:
        opt["ef"] = dict(state.opt["ef"])
    return masters, opt


def _first(v) -> float:
    """PE 0's value of a (*cube) metric (every PE holds the same)."""
    return float(v.reshape(-1)[0]) if torch.is_tensor(v) else float(v)


# ------------------------------------------------------------------ driver
class Trainer:
    """Training loop with straggler deadlines and telemetry."""

    def __init__(self, cfg, topo, tc: TrainConfig, checkpointer=None, *,
                 dtype: torch.dtype = torch.bfloat16):
        self.cfg, self.topo, self.tc = cfg, topo, tc
        self.checkpointer = checkpointer
        self.step_fn = make_train_step(cfg, topo, tc, dtype=dtype)
        self.split_fns = (make_split_train_step(cfg, topo, tc, dtype=dtype)
                          if tc.telemetry_split else None)
        self.slow_steps = 0
        self.step_seconds: list[float] = []   # wall seconds of each step
        self._sync_priced = False

    def _record_step_telemetry(self, dt: float, straggler: bool) -> None:
        _telemetry.inc("train.steps")
        _telemetry.observe("train.step_seconds", dt)
        if straggler:
            _telemetry.inc("train.straggler_steps")

    def _price_sync_estimates(self, events) -> None:
        """Set the grad-sync planner-estimate gauges from the traced step's
        CommEvents: serial = every program-recorded sync second; exposed =
        only the final bucket's, the one the overlap path cannot hide under
        the backward. Events whose ``seconds`` is unset (the port's planner
        leaves it so until the tuner prices it) are skipped."""
        by_prog: dict = {}
        for e in events:
            if (e.program_id and str(e.program_id).startswith("grad-sync")
                    and e.seconds is not None):
                by_prog.setdefault(e.program_id, []).append(e)
        if not by_prog:
            return
        serial = sum(e.seconds for evs in by_prog.values() for e in evs)
        last = max(by_prog, key=lambda pid: int(pid.rsplit("-b", 1)[1])
                   if "-b" in pid else -1)
        exposed = sum(e.seconds for e in by_prog[last])
        _telemetry.set_gauge("train.sync_serial_est_us", serial * 1e6)
        _telemetry.set_gauge("train.sync_exposed_est_us", exposed * 1e6)

    def _run_split_step(self, params, opt_state, batch, sync_dev):
        fwd, fwd_bwd, sync, opt = self.split_fns
        opt_state = dict(opt_state)
        t0 = time.monotonic()
        fwd(params, batch)
        sync_dev()
        t1 = time.monotonic()
        loss, aux, grads = fwd_bwd(params, batch)
        sync_dev()
        t2 = time.monotonic()
        grads = sync(grads, opt_state)
        sync_dev()
        t3 = time.monotonic()
        params, opt_state, om = opt(params, opt_state, grads)
        sync_dev()
        t4 = time.monotonic()
        _telemetry.observe("train.fwd_seconds", t1 - t0)
        _telemetry.observe("train.fwd_bwd_seconds", t2 - t1)
        _telemetry.observe("train.sync_seconds", t3 - t2)
        _telemetry.observe("train.opt_seconds", t4 - t3)
        return params, opt_state, dict(aux, loss=loss, **om)

    def run(self, params, opt_state, batches, *, start_step=0,
            checkpoint_every=0, log_every=1, log=print):
        """Run one step per batch (each on the cube: ``place_batch``).
        Returns ``(params, opt_state, history)``, history a list of float
        metric dicts (PE 0's values). With a checkpointer, every
        ``checkpoint_every``-th step is saved as ``TrainState(params=...,
        opt=...)``; the next step does not wait for the disk write."""
        device = flat_leaves(params)[0].device

        def sync_dev():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        step = start_step
        history = []
        for batch in batches:
            t0 = time.monotonic()
            with _spans.maybe_span("train-step", cat="wall", step=step):
                if self.split_fns is not None:
                    params, opt_state, metrics = self._run_split_step(
                        params, opt_state, batch, sync_dev)
                elif _telemetry.enabled() and not self._sync_priced:
                    # first metered step: trace the grad-sync events once
                    with CommTrace() as ct:
                        params, opt_state, metrics = self.step_fn(
                            params, opt_state, batch)
                    self._price_sync_estimates(ct.events)
                    self._sync_priced = True
                else:
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch)
                # wait for the step's real outputs before reading the clock
                sync_dev()
            metrics = {k: _first(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.step_seconds.append(dt)
            straggler = bool(self.tc.step_deadline_s
                             and dt > self.tc.step_deadline_s)
            if straggler:
                self.slow_steps += 1
                metrics["straggler"] = 1.0
            if _telemetry.enabled():
                self._record_step_telemetry(dt, straggler)
            step += 1
            history.append(metrics)
            if log_every and step % log_every == 0:
                log(f"step {step}: loss={metrics['loss']:.4f} "
                    f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if (checkpoint_every and self.checkpointer
                    and step % checkpoint_every == 0):
                self._save(step, params, opt_state)
        return params, opt_state, history

    def _save(self, step: int, params, opt_state) -> None:
        """Gather-at-dispatch: ``save()`` copies masters and optimizer state
        to the host before it returns (the next step updates both in
        place), then writes them behind the next steps. A manager without
        a topology gets this trainer's, since its leaves are cube
        tensors."""
        from repro_torch.checkpoint.manager import TrainState
        ckpt = self.checkpointer
        kw = {} if ckpt.topo is not None else {
            "topo": self.topo,
            "specs": {"params": param_specs(self.cfg, self.topo),
                      "opt": opt_specs(self.cfg, self.topo, self.tc)}}
        ckpt.save(step, TrainState(params=params, opt=opt_state), **kw)
