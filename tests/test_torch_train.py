"""The port's dense train step held against the JAX package on the CPU.

The reference's ``make_train_step`` is red on this jax (its
``check_vma=True`` shard_map raises on the CE scan carry), so the port is
held to what is green there: ``Model.loss_shard`` under
``shard_map(..., check_vma=False)`` (as ``tests/test_system.py`` runs it),
``jax.grad`` of it on a 1-PE mesh, and a step composed in JAX from that
gradient, the global-norm clip and ``adamw.update``. Weights are the JAX
package's ``init_params`` carried across with ``from_jax_params``; batches
come from the JAX ``TokenStream``. Both packages compute in f32 (the JAX
compute dtype is set with ``monkeypatch``). Multi-PE gradients are held to
the 1-PE ones with the grad-sync program's all-reduces counted.

The loss and the 1-PE gradients are held to JAX for each of the seven
ported decoder-only archs (smoke configs; gemma3 with ``n_layers=12``, so
that a global layer runs; internlm2 with 12 / 2 heads, its G = 6). MoE's loss depends on the layout (capacity is per shard), so
its multi-PE gradients are held to autograd through the broadcast masters
instead of to 1 PE's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.blocks as jax_blocks
import repro.models.lm as jax_lm
import repro.models.params as jax_params
from repro.compat import shard_map
from repro.configs import get as jax_get
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenStream as JaxTokenStream
from repro.launch.mesh import make_mesh
from repro.models.topology import build_topology as jax_topology
from repro.optim import adamw as jax_adamw
from repro.runtime.trainer import input_batch_specs as jax_batch_specs

from repro_torch import configs
from repro_torch.core import program
from repro_torch.core.comm import CommTrace
from repro_torch.kernels.attention import flash, flash_bwd
from repro_torch.launch import train as launcher
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    compact, flat_leaves, from_jax_params, param_specs, to_global,
    trainable, tree_map)
from repro_torch.models.topology import build_topology
from repro_torch.optim import adamw
from repro_torch.runtime import trainer as tr
from repro_torch.telemetry import metrics as telemetry

ARCH = "qwen3-1.7b"
MOE = "qwen2-moe-a2.7b"
OTHER_ARCHS = (MOE, "mixtral-8x7b", "rwkv6-7b", "phi3-mini-3.8b",
               "gemma3-1b", "internlm2-20b")
# gemma3's stock smoke config has 2 local layers and no global one;
# internlm2 keeps its own G = 6 (48 / 8 heads) as 12 / 2
SMOKE_CHANGES = {"gemma3-1b": {"n_layers": 12},
                 "internlm2-20b": {"n_heads": 12, "n_kv_heads": 2}}
CPU = torch.device("cpu")
LOSS_TOL = 1e-5     # relative, f32 in both packages
GRAD_TOL = 1e-4     # x max(1, max|ref|) per leaf
STEP_TOL = 1e-5     # x max(1, max|ref|) per leaf, after 2 steps
# (data, tp) layouts of the cube: 1, 2 and 4 PEs, tensor- and data-parallel
LAYOUTS = [(1, 1), (1, 2), (2, 1), (1, 4), (2, 2)]


def _lid(layout):
    return f"{layout[0]}x{layout[1]}"


# qwen3 over every layout, masked rows and not; the other archs at 1 PE
# and tp (ep for MoE) 2, and MoE also at 2 x 2
LOSS_CASES = (
    [pytest.param(ARCH, lay, mask, id=f"{mask}-{_lid(lay)}")
     for mask in (False, True) for lay in LAYOUTS]
    + [pytest.param(a, lay, False, id=f"{a}-{_lid(lay)}")
       for a in OTHER_ARCHS for lay in [(1, 1), (1, 2)]]
    + [pytest.param(MOE, (2, 2), False, id=f"{MOE}-2x2")])


@pytest.fixture
def f32_reference(monkeypatch):
    """The JAX package's compute in f32."""
    for mod in (jax_params, jax_blocks, jax_lm):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


@pytest.fixture
def pvary_identity(monkeypatch):
    """``jax.grad`` of the reference's ``loss_shard`` on a 1-PE mesh.
    ``compat.pvary`` marks a value varying over an axis (the CE carry over
    ``data``); under ``check_vma=False`` its transpose is a psum over an
    axis the cotangent does not vary over, which jax 0.9 rejects. On one
    PE it is the identity in value and in gradient, so it is set to that."""
    import repro.compat as jax_compat
    monkeypatch.setattr(jax_compat, "pvary", lambda x, axes: x)


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    program.clear_lower_cache()
    for k in program.LOWER_STATS:
        program.LOWER_STATS[k] = 0
    telemetry.disable()
    telemetry.REGISTRY.reset()


def _cfgs(tp, arch=ARCH):
    """The smoke configs of both packages with model parallelism ``tp``:
    tensor parallelism, or for an MoE arch expert parallelism (etp 1)."""
    def cut(cfg):
        cfg = dataclasses.replace(cfg.scaled_for_smoke(),
                                  **SMOKE_CHANGES.get(arch, {}))
        return dataclasses.replace(
            cfg, **({"ep": tp, "etp": 1} if cfg.n_experts else {"tp": tp}))
    return cut(jax_get(arch)), cut(configs.get(arch))


def _jax_setup(data, tp, seed=0, arch=ARCH):
    jcfg, _ = _cfgs(tp, arch)
    jtopo = jax_topology(jcfg, make_mesh((data, tp), ("data", "model")))
    return jcfg, jtopo, jax_params.init_params(jcfg, jtopo, seed=seed)


def _jax_loss_fn(jcfg, jtopo):
    model = jax_lm.Model(jcfg, jtopo)
    return jax.jit(shard_map(
        lambda p, b: model.loss_shard(p, b)[0], mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  jax_batch_specs(jcfg, jtopo)),
        out_specs=P(), check_vma=False))


def _batch(B=2, S=24, seed=0, mask_row=False):
    """A JAX TokenStream batch (labels carry -1 at document breaks)."""
    jcfg = jax_get(ARCH).scaled_for_smoke()
    b = JaxTokenStream(jcfg, JaxDataConfig(
        seq_len=S, global_batch=B, vocab_size=jcfg.vocab_size,
        seed=seed, doc_len_mean=8)).global_batch_at(seed)
    if mask_row:
        b = {"tokens": np.concatenate([b["tokens"], b["tokens"][:1]]),
             "labels": np.concatenate(
                 [b["labels"], np.full((1, S), -1, np.int32)])}
    return b


def _port(data, tp, jparams, arch=ARCH):
    _, pcfg = _cfgs(tp, arch)
    topo = build_topology(pcfg, data * tp)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    masters = trainable(params, param_specs(pcfg, topo), topo.cube)
    return pcfg, topo, masters


def _first(v):
    return float(v.reshape(-1)[0])


# --------------------------------------------------------------------- loss
@pytest.mark.parametrize("arch,layout,mask_row", LOSS_CASES)
def test_loss_shard_matches_jax(f32_reference, arch, layout, mask_row):
    data, tp = layout
    jcfg, jtopo, jparams = _jax_setup(data, tp, arch=arch)
    b = _batch(B=2 * data, mask_row=False)
    if mask_row:      # data-parallel split needs an even batch: mask 2 rows
        b = {"tokens": np.concatenate([b["tokens"], b["tokens"]]),
             "labels": np.concatenate(
                 [b["labels"], np.full_like(b["labels"], -1)])}
    ref = float(_jax_loss_fn(jcfg, jtopo)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()}))
    pcfg, topo, masters = _port(data, tp, jparams, arch)
    with torch.no_grad():
        loss, metrics = Model(pcfg, topo, dtype=torch.float32).loss_shard(
            tr.view_leaves(masters, topo.cube),
            tr.place_batch(b, pcfg, topo, CPU))
    assert loss.shape == topo.cube.dim_sizes
    assert bool((loss == loss.reshape(-1)[0]).all())   # one value on every PE
    assert abs(_first(loss) - ref) <= LOSS_TOL * abs(ref)
    assert _first(metrics["tokens"]) == float((b["labels"] >= 0).sum())


def test_loss_invariant_to_masked_rows(f32_reference):
    """Masked (-1) labels never contribute: appending a fully-masked row
    leaves the port's loss unchanged (the invariant of
    ``tests/test_system.py``), at 2 PEs of tensor parallelism."""
    jcfg, jtopo, jparams = _jax_setup(1, 2)
    pcfg, topo, masters = _port(1, 2, jparams)
    model = Model(pcfg, topo, dtype=torch.float32)
    views = tr.view_leaves(masters, topo.cube)
    with torch.no_grad():
        l1 = model.loss_shard(views, tr.place_batch(_batch(), pcfg, topo,
                                                    CPU))[0]
        l2 = model.loss_shard(views, tr.place_batch(
            _batch(mask_row=True), pcfg, topo, CPU))[0]
    assert abs(_first(l1) - _first(l2)) <= LOSS_TOL * abs(_first(l1))


# ---------------------------------------------------------------- gradients
def _jax_grad_fn(jcfg, jtopo):
    """``jax.grad`` of ``loss_shard`` taken inside the shard_map body (on a
    1-PE mesh the per-shard gradient is the gradient)."""
    model = jax_lm.Model(jcfg, jtopo)
    specs = jax_params.param_specs(jcfg, jtopo)
    return jax.jit(shard_map(
        lambda p, b: jax.grad(lambda q: model.loss_shard(q, b)[0])(p),
        mesh=jtopo.cube.mesh,
        in_specs=(specs, jax_batch_specs(jcfg, jtopo)), out_specs=specs,
        check_vma=False))


def _jax_grads(jcfg, jtopo, jparams, b):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    return jax.tree.map(np.asarray,
                        _jax_grad_fn(jcfg, jtopo)(jparams, jb))


def _port_grads(pcfg, topo, masters, b, *, overlap=False):
    """The step's synced per-PE gradients, compact, as global arrays."""
    step = tr.make_train_step(pcfg, topo, tr.TrainConfig(),
                              dtype=torch.float32)
    _, _, grads = step.fwd_bwd(masters, tr.place_batch(b, pcfg, topo, CPU),
                               overlap=overlap)
    if not overlap:
        grads = step.sync(grads, {})
    specs = param_specs(pcfg, topo)
    cgrads = tree_map(lambda g, s: compact(g, s, topo.cube), grads, specs)
    return to_global(cgrads, specs, topo.cube)


def _close(got, want, tol):
    for a, b in zip(flat_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= tol * max(1.0,
                                                        np.abs(b).max())


def _single_pe_grads_match_jax_grad(arch):
    jcfg, jtopo, jparams = _jax_setup(1, 1, arch=arch)
    b = _batch()
    ref = _jax_grads(jcfg, jtopo, jparams, b)
    pcfg, topo, masters = _port(1, 1, jparams, arch)
    got = _port_grads(pcfg, topo, masters, b)
    _close(got, ref, GRAD_TOL)
    # every leaf received a gradient
    assert all(float(g.abs().max()) > 0 for g in flat_leaves(got))


def test_single_pe_grads_match_jax_grad(f32_reference, pvary_identity):
    _single_pe_grads_match_jax_grad(ARCH)


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_single_pe_grads_match_jax_grad_other_archs(f32_reference,
                                                    pvary_identity, arch):
    """The same for the other ported archs: MoE's experts and router, the
    RWKV6 time-mix and channel-mix (through ``RWKV6Chunked`` and its plain
    backward), phi3's and gemma3's attention (gemma3's windows)."""
    _single_pe_grads_match_jax_grad(arch)


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)], ids=_lid)
def test_moe_multi_pe_grads_match_autograd_through_broadcast(f32_reference,
                                                             layout):
    """MoE at ep 2 (and data 2): the step's per-PE gradients, synced by the
    grad-sync program, equal autograd of the same loss through the compact
    masters broadcast over the cube (which sums every replica's partial),
    bit for bit. The all_to_alls' reorders run forward and backward
    (``TileSwizzle``) on both sides."""
    data, tp = layout
    _, _, jparams = _jax_setup(data, tp, arch=MOE)
    pcfg, topo, masters = _port(data, tp, jparams, MOE)
    b = _batch(B=2 * data)
    cube = topo.cube
    specs = param_specs(pcfg, topo)
    batch = tr.place_batch(b, pcfg, topo, CPU)
    calls = []
    from repro_torch.kernels.reorder import ops as reorder_ops
    swizzle = reorder_ops._dispatch

    def counting(x, perm):
        calls.append(tuple(x.shape))
        return swizzle(x, perm)

    reorder_ops._dispatch = counting
    try:
        step = tr.make_train_step(pcfg, topo, tr.TrainConfig(),
                                  dtype=torch.float32)
        _, _, raw = step.fwd_bwd(masters, batch)
        n_step = len(calls)
        synced = step.sync(raw, {})
        got = tree_map(lambda g, s: compact(g, s, cube), synced, specs)
        leaves = tree_map(lambda m: m.detach().clone().requires_grad_(),
                          masters)
        views = tree_map(lambda m: m.expand(
            cube.dim_sizes + tuple(m.shape[cube.ndim:])), leaves)
        loss, _ = Model(pcfg, topo, dtype=torch.float32).loss_shard(views,
                                                                   batch)
        loss.mean().backward()
    finally:
        reorder_ops._dispatch = swizzle
    # two all_to_alls a layer: forward, remat recompute, backward
    assert n_step == 6 * pcfg.n_layers
    for g, m in zip(flat_leaves(got), flat_leaves(leaves)):
        assert torch.equal(g, m.grad)


@pytest.mark.parametrize("layout", LAYOUTS[1:], ids=lambda l: f"{l[0]}x{l[1]}")
def test_multi_pe_grads_match_single_pe(f32_reference, layout):
    """The 2- and 4-PE gradients equal the 1-PE ones, and the replicated
    leaves' sums went through the grad-sync program: its all-reduces are
    counted, and without them the per-PE partials would not match."""
    data, tp = layout
    _, _, jparams = _jax_setup(data, tp)
    b = _batch(B=2 * data)
    p1 = _port(1, 1, _jax_setup(1, 1)[2])
    ref = _port_grads(*p1, b)
    pcfg, topo, masters = _port(data, tp, jparams)
    specs = param_specs(pcfg, topo)
    n_repl = sum(bool(tr.replication_dims(s, topo.cube))
                 for s in flat_leaves(specs))
    assert n_repl > 0
    with CommTrace() as ct:
        got = _port_grads(pcfg, topo, masters, b)
    syncs = [e for e in ct.events
             if e.program_id == "grad-sync" and e.primitive == "all_reduce"]
    assert syncs, "no grad-sync all-reduce was dispatched"
    assert sum(len(e.fused_from) or 1 for e in syncs) == n_repl
    _close(got, jax.tree.map(lambda t: t.numpy(), ref), GRAD_TOL)

    # the partials before the sync: index 0 alone misses the other PEs'
    step = tr.make_train_step(pcfg, topo, tr.TrainConfig(),
                              dtype=torch.float32)
    _, _, raw = step.fwd_bwd(masters, tr.place_batch(b, pcfg, topo, CPU))
    unsynced = to_global(tree_map(lambda g, s: compact(g, s, topo.cube),
                                  raw, specs), specs, topo.cube)
    worst = max(float((u - r).abs().max() / r.abs().max())
                for u, r, s in zip(flat_leaves(unsynced), flat_leaves(ref),
                                   flat_leaves(specs))
                if tr.replication_dims(s, topo.cube))
    assert worst > 0.1


def test_overlapped_sync_bit_identical_to_barrier(f32_reference):
    _, _, jparams = _jax_setup(2, 2)
    pcfg, topo, masters = _port(2, 2, jparams)
    b = _batch(B=4)
    barrier = _port_grads(pcfg, topo, masters, b)
    with CommTrace() as ct:
        hooked = _port_grads(pcfg, topo, masters, b, overlap=True)
    for a, c in zip(flat_leaves(barrier), flat_leaves(hooked)):
        assert torch.equal(a, c)
    pids = [e.program_id for e in ct.events
            if e.program_id and e.program_id.startswith("grad-sync-b")]
    assert set(pids) == {"grad-sync-b0", "grad-sync-b1"}
    assert pids == sorted(pids), pids


# --------------------------------------------------------------- the step
def _jax_step(jcfg, jtopo, tc, params, state, b):
    """One step composed in JAX: jax.grad of loss_shard (1 PE), the
    global-norm clip, cosine lr, adamw.update."""
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    g = _jax_grad_fn(jcfg, jtopo)(params, jb)
    sq = sum(jnp.sum(jnp.square(x)) for x in jax.tree.leaves(g))
    gnorm = jnp.sqrt(sq)
    scale = jnp.minimum(1.0, tc.clip_norm / jnp.maximum(gnorm, 1e-12))
    g = jax.tree.map(lambda x: x * scale, g)
    lr = jax_adamw.cosine_schedule(tc.lr, tc.warmup, tc.total_steps)(
        state["step"])
    jtc = jax_adamw.AdamWConfig(use_8bit=tc.adamw.use_8bit)
    return jax_adamw.update(params, state, g, lr=lr, cfg=jtc)


@pytest.mark.parametrize("layout", [(1, 1), (1, 2)],
                         ids=lambda l: f"{l[0]}x{l[1]}")
def test_train_step_matches_composed_jax_step(f32_reference, pvary_identity,
                                             layout):
    data, tp = layout
    tc = tr.TrainConfig(lr=1e-3, warmup=1, total_steps=10,
                        adamw=adamw.AdamWConfig(use_8bit=False))
    jcfg, jtopo, jparams = _jax_setup(1, 1)
    jstate = jax_adamw.init_state(
        jparams, jax_adamw.AdamWConfig(use_8bit=False))
    pcfg, topo, masters = _port(data, tp, jparams)
    opt = tr.init_opt_state(masters, pcfg, topo, tc)
    step = tr.make_train_step(pcfg, topo, tc, dtype=torch.float32)
    for s in range(2):
        b = _batch(seed=s)
        jparams, jstate = _jax_step(jcfg, jtopo, tc, jparams, jstate, b)
        masters, opt, _ = step(masters, opt, tr.place_batch(b, pcfg, topo,
                                                            CPU))
    got = to_global(masters, param_specs(pcfg, topo), topo.cube)
    _close(got, jax.tree.map(np.asarray, jparams), STEP_TOL)
    assert int(opt["step"]) == 2


# ------------------------------------------------------------- the driver
def _smoke_trainer(tc, pes=2):
    _, pcfg = _cfgs(1)
    topo = build_topology(pcfg, pes)
    from repro_torch.models.params import init_params
    masters = trainable(init_params(pcfg, topo, 0, device=CPU),
                        param_specs(pcfg, topo), topo.cube)
    opt = tr.init_opt_state(masters, pcfg, topo, tc)
    return pcfg, topo, masters, opt


def test_trainer_run_history_straggler_and_telemetry():
    tc = tr.TrainConfig(warmup=2, lr=1e-3, step_deadline_s=1e-9)
    pcfg, topo, masters, opt = _smoke_trainer(tc)
    telemetry.enable()
    trainer = tr.Trainer(pcfg, topo, tc, dtype=torch.float32)
    batches = [tr.place_batch(_batch(seed=s), pcfg, topo, CPU)
               for s in range(3)]
    _, opt, hist = trainer.run(masters, opt, batches, log_every=0)
    assert len(hist) == 3 and trainer.slow_steps == 3
    assert set(hist[0]) == {"ce_loss", "aux_loss", "tokens", "loss",
                            "grad_norm", "lr", "straggler"}
    assert all(np.isfinite(h["loss"]) for h in hist)
    snap = telemetry.REGISTRY.snapshot()
    assert snap["train.steps"]["value"] == 3
    assert snap["train.straggler_steps"]["value"] == 3
    assert snap["train.step_seconds"]["count"] == 3
    # the port's planner leaves seconds unset: no sync-estimate gauge
    assert "train.sync_serial_est_us" not in snap
    assert int(opt["step"]) == 3


def test_trainer_split_phases_time_each():
    tc = tr.TrainConfig(warmup=2, lr=1e-3, telemetry_split=True)
    pcfg, topo, masters, opt = _smoke_trainer(tc)
    telemetry.enable()
    trainer = tr.Trainer(pcfg, topo, tc, dtype=torch.float32)
    _, _, hist = trainer.run(masters, opt, [tr.place_batch(
        _batch(), pcfg, topo, CPU)], log_every=0)
    snap = telemetry.REGISTRY.snapshot()
    for name in ("fwd", "fwd_bwd", "sync", "opt"):
        assert snap[f"train.{name}_seconds"]["count"] == 1
    assert np.isfinite(hist[0]["loss"])


def test_trainer_checkpointer_raises(tmp_path, monkeypatch):
    """A checkpoint write that fails behind the steps is not swallowed by
    the loop: the next save inside ``Trainer.run`` raises it."""
    from repro_torch.checkpoint import CheckpointManager
    tc = tr.TrainConfig()
    pcfg, topo, masters, opt = _smoke_trainer(tc)
    b = tr.place_batch(_batch(), pcfg, topo, CPU)

    def failing_save(*a, **k):
        raise OSError("disk full (simulated)")

    monkeypatch.setattr(np, "save", failing_save)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    trainer = tr.Trainer(pcfg, topo, tc, checkpointer=mgr,
                         dtype=torch.float32)
    with pytest.raises(OSError, match="disk full"):
        trainer.run(masters, opt, [b] * 3, checkpoint_every=1, log_every=0)
    assert len(trainer.step_seconds) == 2 and mgr.all_steps() == []


def test_loss_falls_on_a_repeated_batch():
    tc = tr.TrainConfig(warmup=1, lr=3e-3)
    pcfg, topo, masters, opt = _smoke_trainer(tc)
    b = tr.place_batch(_batch(), pcfg, topo, CPU)
    trainer = tr.Trainer(pcfg, topo, tc, dtype=torch.float32)
    _, _, hist = trainer.run(masters, opt, [b] * 10, log_every=0)
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] - 0.05, losses


def test_grad_sync_program_lowers_once():
    tc = tr.TrainConfig(overlap_grad_sync=False)
    pcfg, topo, masters, opt = _smoke_trainer(tc, pes=2)
    pcfg = dataclasses.replace(pcfg, tp=2)
    topo = build_topology(pcfg, 2)
    from repro_torch.models.params import init_params
    masters = trainable(init_params(pcfg, topo, 0, device=CPU),
                        param_specs(pcfg, topo), topo.cube)
    opt = tr.init_opt_state(masters, pcfg, topo, tc)
    trainer = tr.Trainer(pcfg, topo, tc, dtype=torch.float32)
    program.clear_lower_cache()
    before = dict(program.LOWER_STATS)
    trainer.run(masters, opt, [tr.place_batch(_batch(seed=s), pcfg, topo,
                                              CPU) for s in range(3)],
                log_every=0)
    assert program.LOWER_STATS["lowered"] - before["lowered"] == 1
    assert program.LOWER_STATS["cache_hits"] - before["cache_hits"] == 2


# ------------------------------------------------------------ the launcher
def test_launcher_trains_on_cpu(capsys):
    run = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--pes", "2", "--steps", "3", "--batch", "2",
                         "--seq", "16"])
    out = capsys.readouterr().out
    assert "final loss" in out and len(run["history"]) == 3
    assert run["flash_launches"] == 0 and run["flash_bwd_launches"] == 0
    assert run["topo"].cube.dim_sizes == (2, 1)


def test_launcher_needs_a_gpu_or_cpu_flag(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        launcher.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    # a checkpointed, resumed run does not fall back to the CPU either
    with pytest.raises(RuntimeError, match="no GPU"):
        launcher.main(["--arch", ARCH, "--smoke", "--steps", "1",
                       "--ckpt-dir", str(tmp_path), "--resume"])


@pytest.mark.cuda
def test_train_step_launches_both_kernels_on_the_card():
    """On the card one step launches the forward kernel twice per layer
    (the forward and its recomputation) and the backward once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.models.params import init_params
    dev = torch.device("cuda")
    pcfg = _cfgs(1)[1]            # the smoke head_dim, 16
    topo = build_topology(pcfg, 1)
    masters = trainable(init_params(pcfg, topo, 0, device=dev),
                        param_specs(pcfg, topo), topo.cube)
    tc = tr.TrainConfig()
    opt = tr.init_opt_state(masters, pcfg, topo, tc)
    f0, b0 = flash.LAUNCHES, flash_bwd.LAUNCHES
    tr.make_train_step(pcfg, topo, tc)(
        masters, opt, tr.place_batch(_batch(), pcfg, topo, dev))
    torch.cuda.synchronize()
    assert flash.LAUNCHES - f0 == 2 * pcfg.n_layers
    assert flash_bwd.LAUNCHES - b0 == pcfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch,pes", [(MOE, 8), ("rwkv6-7b", 1)])
def test_moe_and_rwkv6_train_on_the_card(arch, pes):
    """qwen2-moe at ep 8 and rwkv6 train a step on the card: the remat
    runs each layer's forward twice, so a step launches the reorder 6 times
    a MoE layer (two all_to_alls: forward, recompute, backward with the
    inverse perm), and the RWKV6 forward twice and its backward once a
    layer; the loss is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.reorder import reorder
    from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_bwd
    from repro_torch.models.params import init_params
    dev = torch.device("cuda")
    pcfg = _cfgs(pes, arch)[1]
    if pcfg.n_experts:             # 8 query heads for 8 PEs
        pcfg = dataclasses.replace(pcfg, n_heads=8, n_kv_heads=8)
    topo = build_topology(pcfg, pes)
    masters = trainable(init_params(pcfg, topo, 0, device=dev),
                        param_specs(pcfg, topo), topo.cube)
    tc = tr.TrainConfig()
    opt = tr.init_opt_state(masters, pcfg, topo, tc)
    kernels = (flash, flash_bwd, reorder, rwkv6, rwkv6_bwd)
    n0 = [m.LAUNCHES for m in kernels]
    _, _, m = tr.make_train_step(pcfg, topo, tc)(
        masters, opt, tr.place_batch(_batch(), pcfg, topo, dev))
    torch.cuda.synchronize()
    got = [k.LAUNCHES - n for k, n in zip(kernels, n0)]
    L = pcfg.n_layers
    want = ([2 * L, L, 6 * L, 0, 0] if pcfg.n_experts
            else [0, 0, 0, 2 * L, L])
    assert got == want
    assert np.isfinite(_first(m["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,pes", [("phi3-mini-3.8b", 1),
                                      ("gemma3-1b", 1),
                                      ("mixtral-8x7b", 8)])
def test_other_archs_train_on_the_card(arch, pes):
    """phi3-mini at its head dim 96, gemma3 at 256 (12 layers: local
    windows and global layers) and mixtral at ep 8 (8 experts, one a PE)
    train a step on the card: 2 L flash forwards with row statistics and L
    backwards, and for mixtral 6 L reorders (two all_to_alls a layer:
    forward, recompute, backward); the loss is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.reorder import reorder
    from repro_torch.models.params import init_params
    dev = torch.device("cuda")
    pcfg = dataclasses.replace(configs.get(arch).scaled_for_smoke(),
                               **SMOKE_CHANGES.get(arch, {}))
    if pcfg.n_experts:             # 8 experts and 8 query heads for ep 8
        pcfg = dataclasses.replace(pcfg, n_experts=8, n_heads=8,
                                   n_kv_heads=8, ep=pes, etp=1)
    else:
        pcfg = dataclasses.replace(pcfg, head_dim=configs.get(
            arch).head_dim, tp=pes)
    topo = build_topology(pcfg, pes)
    masters = trainable(init_params(pcfg, topo, 0, device=dev),
                        param_specs(pcfg, topo), topo.cube)
    tc = tr.TrainConfig()
    opt = tr.init_opt_state(masters, pcfg, topo, tc)
    kernels = (flash, flash_bwd, reorder)
    n0 = [m.LAUNCHES for m in kernels]
    _, _, m = tr.make_train_step(pcfg, topo, tc)(
        masters, opt, tr.place_batch(_batch(), pcfg, topo, dev))
    torch.cuda.synchronize()
    L = pcfg.n_layers
    assert [k.LAUNCHES - n for k, n in zip(kernels, n0)] == [
        2 * L, L, 6 * L if pes > 1 else 0]
    assert np.isfinite(_first(m["loss"]))


def test_spec_helpers_match_jax():
    """``drop_axis`` and ``grad_sum_spec`` give the JAX package's trees."""
    from repro_torch.models.params import drop_axis, grad_sum_spec
    jcfg, jtopo, _ = _jax_setup(2, 2)
    _, pcfg = _cfgs(2)
    topo = build_topology(pcfg, 4)
    def norm(spec):      # a one-name tuple entry is the name, as in P
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in tuple(spec))

    want = [norm(s) for s in jax.tree.leaves(
        jax_params.drop_axis(jax_params.param_specs(jcfg, jtopo)),
        is_leaf=lambda x: isinstance(x, P))]
    got = [norm(s) for s in flat_leaves(drop_axis(param_specs(pcfg, topo)))]
    assert got == want and all("data" not in s for s in got)
    want = jax.tree.leaves(jax_params.grad_sum_spec(jcfg, jtopo),
                           is_leaf=lambda x: isinstance(x, tuple))
    assert flat_leaves(grad_sum_spec(pcfg, topo)) == want


def test_compressed_pod_grads_with_error_feedback():
    """Across two pods the replicated gradients take the int8 §V-C hop
    with error feedback: the buffers live in opt_state["ef"] (one per leaf
    whose replication crosses the pod), fill after a step, and the step's
    gradients stay within the int8 error of the exact sync."""
    _, pcfg = _cfgs(2)
    topo = build_topology(pcfg, 4, pods=2)
    assert topo.cube.dcn_dims == ("pod",)
    from repro_torch.models.params import init_params
    specs = param_specs(pcfg, topo)
    tc = tr.TrainConfig(compress_pod_grads=True)
    assert tr.use_error_feedback(tc, topo.cube)
    masters = trainable(init_params(pcfg, topo, 0, device=CPU), specs,
                        topo.cube)
    opt = tr.init_opt_state(masters, pcfg, topo, tc)
    ospecs = tr.opt_specs(pcfg, topo, tc)
    assert sorted(opt["ef"]) == sorted(ospecs["ef"]) and opt["ef"]
    assert sorted(opt["mu"]) == sorted(ospecs["mu"])
    step = tr.make_train_step(pcfg, topo, tc, dtype=torch.float32)
    batch = tr.place_batch(_batch(B=2), pcfg, topo, CPU)
    _, _, raw = step.fwd_bwd(masters, batch)
    exact = tr.sync_replicated_grads(raw, specs, topo.cube)
    state = dict(opt)
    compressed = step.sync(raw, state)
    flat_e, flat_c = flat_leaves(exact), flat_leaves(compressed)
    for key, err in state["ef"].items():
        i = int(key)
        scale = float(flat_e[i].abs().max())
        assert float((flat_c[i] - flat_e[i]).abs().max()) <= scale / 64
        assert float(err.abs().max()) > 0
    masters, opt, m = step(masters, opt, batch)
    assert np.isfinite(_first(m["loss"])) and "ef" in opt
