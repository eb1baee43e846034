"""The port's elastic checkpointing (``repro_torch.checkpoint``) on the CPU,
case for case with ``tests/test_checkpoint.py`` and held against the JAX
package.

Layout: leaf records and the fingerprint equal JAX's on the same state;
foreign entries, killed writers and the GC horizon. Files cross packages:
a JAX save restores in the port and a port save in JAX, bit for bit, for
params and int8 AdamW state at 1 PE and at tp 2. Elastic params-only
restore equals direct init on another cube and the NumPy placement oracle
for the five ported architectures. Async: write errors surface once at
``wait()`` or the next ``save()``, spans cross threads, the train step
behind a save finishes before the write is durable, and the save's gather
program hits the lower cache. Restart: a resumed f32 run is bit-identical
to an uninterrupted one, through ``Trainer`` and through the launcher's
``--ckpt-dir --ckpt-every --resume``. Restore-for-serving decodes with the
engine. The error-feedback buffers of a pod-crossing cube round-trip and
equal the JAX ``ef`` leaves. HF import / export equals the JAX package's
on F32 and BF16 safetensors and on ``pytorch_model.bin`` files written by
either package. Every file is written by the test; nothing is downloaded.
"""
import dataclasses
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import hf_import as jax_hf
from repro.checkpoint import layout as jax_layout
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.checkpoint.manager import TrainState as JaxTrainState
from repro.configs import get as jax_get
from repro.launch.mesh import make_mesh
from repro.models import params as jax_params
from repro.models.topology import build_topology as jax_topology
from repro.optim import adamw as jax_adamw
from repro.runtime import trainer as jax_trainer
from repro.testing import oracles

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, TrainState
from repro_torch.checkpoint import hf_import, layout, reshard
from repro_torch.core import program
from repro_torch.core.comm import CommTrace
from repro_torch.core.hypercube import Hypercube
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.launch import train as launcher
from repro_torch.models.params import (
    flat_leaves, from_jax_opt_state, from_jax_params, init_params, leaves,
    param_defs, param_specs, to_global, trainable, tree_map)
from repro_torch.models.serving import make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology
from repro_torch.runtime import trainer as tr
from repro_torch.serving import Request, ServeEngine
from repro_torch import telemetry

ARCH = "qwen3-1.7b"
CPU = torch.device("cpu")
ELASTIC_ARCHS = ["qwen3-1.7b", "gemma3-1b", "phi3-mini-3.8b",
                 "qwen2-moe-a2.7b", "rwkv6-7b"]


@pytest.fixture(autouse=True)
def _reset_port_state():
    program.clear_lower_cache()
    for k in program.LOWER_STATS:
        program.LOWER_STATS[k] = 0
    yield
    program.clear_lower_cache()
    for k in program.LOWER_STATS:
        program.LOWER_STATS[k] = 0
    telemetry.disable_metrics()
    telemetry.REGISTRY.reset()


def _tiny_state(seed=0):
    """Global CPU tensors (a topology-free manager's leaves)."""
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(4, 8, generator=g),
              "b": {"scale": torch.randn(8, generator=g)}}
    opt = {"m": {"w": torch.zeros(4, 8), "b": {"scale": torch.zeros(8)}},
           "count": torch.tensor(3, dtype=torch.int32)}
    return TrainState(params=params, opt=opt)


def _assert_tree_equal(a, b):
    la, lb = list(layout.flatten(a)), list(layout.flatten(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        y = y if isinstance(y, torch.Tensor) else torch.as_tensor(
            np.asarray(y))
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _mgr(root, **kw):
    return CheckpointManager(str(root), device="cpu", **kw)


# ------------------------------------------------------------ JAX helpers
def _cfgs(arch=ARCH, tp=1):
    jcfg = dataclasses.replace(jax_get(arch).scaled_for_smoke(), tp=tp)
    pcfg = dataclasses.replace(configs.get(arch).scaled_for_smoke(), tp=tp)
    return jcfg, pcfg


def _random_jax_state(jcfg, jtopo, tc, seed=0):
    """The JAX package's params (``init_params``) and an AdamW state with
    random nonzero int8 moments and scales in the train step's global
    layout (``opt_structs``: one scale column per shard of the weight's
    last axis), placed under the JAX opt specs; with the NumPy globals."""
    jp = jax_params.init_params(jcfg, jtopo, seed=seed)
    rng = np.random.default_rng(seed)

    def draw(struct):
        if struct.dtype == np.int8:
            return rng.integers(-127, 128, struct.shape, dtype=np.int8)
        if struct.dtype == np.int32:
            return np.asarray(rng.integers(1, 100), np.int32).reshape(
                struct.shape)
        return rng.random(struct.shape, dtype=np.float32) + 0.5

    structs = jax_trainer.opt_structs(jcfg, jtopo, tc)
    host = jax.tree.map(draw, structs)
    jo = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding), host,
                      structs)
    return jp, jo, jax.tree.map(np.asarray, jp), host


def _global(tree, specs, cube):
    return {"/".join(p): cube.from_cube(x, s) if x.dim() >= cube.ndim
            else x for (p, x), (_, s) in zip(leaves(tree), leaves(specs))}


# ------------------------------------------------------------------ layout
def test_leaf_records_and_fingerprint_equal_jax(tmp_path):
    """A qwen3 TrainState (int8 moments, step): the port's manifest records
    and fingerprint equal the JAX package's ``leaf_records`` of the same
    state, carried across with from_jax_params / from_jax_opt_state."""
    jcfg, pcfg = _cfgs()
    jtopo = jax_topology(jcfg, make_mesh((1, 1), ("data", "model")))
    tc = tr.TrainConfig()
    jp, jo, hp, ho = _random_jax_state(jcfg, jtopo, jax_trainer.TrainConfig())
    want = jax_layout.leaf_records({"opt": jo, "params": jp})
    ptopo = build_topology(pcfg, 1)
    masters = trainable(from_jax_params(pcfg, ptopo, hp, device=CPU),
                        param_specs(pcfg, ptopo), ptopo.cube)
    opt = from_jax_opt_state(pcfg, ptopo, ho, device=CPU)
    mgr = _mgr(tmp_path, topo=ptopo, async_save=False,
               specs={"params": param_specs(pcfg, ptopo),
                      "opt": tr.opt_specs(pcfg, ptopo, tc)})
    mgr.save(3, TrainState(params=masters, opt=opt))
    man = layout.read_manifest(layout.step_dir(str(tmp_path), 3))
    assert man["leaves"] == want
    assert man["fingerprint"] == jax_layout.fingerprint(want)
    assert man["sections"] == {"opt": len(jax.tree.leaves(jo)),
                               "params": len(jax.tree.leaves(jp))}
    assert man["cube"] == {"data": 1, "tp": 1}
    # the NumPy globals give the same records through the port's layout
    assert layout.leaf_records({"opt": ho, "params": hp}) == want


def test_flatten_order_is_jax_order():
    """Sorted keys ("10" before "2"), a None node an empty subtree, spec
    tuples leaves: the order of ``jax.tree.flatten``."""
    tree = {"params": {"b": np.zeros(2), "a": np.zeros(1)},
            "opt": {"ef": {"2": np.zeros(3), "10": np.zeros(4)},
                    "none": None}}
    jax_paths = [tuple(k.key for k in p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in layout.flatten(tree)] == jax_paths
    assert list(layout.flatten({"opt": None})) == []
    assert [s for _, s in layout.flatten({"a": (None, "tp"), "b": ()})] == \
        [(None, "tp"), ()]


def test_all_steps_ignores_foreign_entries(tmp_path):
    root = str(tmp_path)
    mgr = _mgr(root, async_save=False)
    mgr.save(10, _tiny_state())
    mgr.save(20, _tiny_state())
    os.makedirs(os.path.join(root, "step_00000030.tmp"))  # killed writer
    os.makedirs(os.path.join(root, "notastep"))
    open(os.path.join(root, "step_00000040"), "w").close()  # file, not dir
    open(os.path.join(root, "events.log"), "w").close()
    os.makedirs(os.path.join(root, "step_123"))  # wrong digit count
    assert mgr.all_steps() == [10, 20]
    assert mgr.latest_step() == 20


def test_killed_mid_write_is_invisible_and_retry_wins(tmp_path):
    root = str(tmp_path)
    mgr = _mgr(root, async_save=False)
    debris = os.path.join(root, "step_00000005.tmp")
    os.makedirs(debris)
    np.save(os.path.join(debris, "arr_0.npy"), np.zeros(3))
    open(os.path.join(debris, "garbage"), "w").close()

    assert mgr.all_steps() == []
    with pytest.raises(FileNotFoundError, match="no checkpoint for step 5"):
        mgr.restore(5)

    state = _tiny_state(seed=7)
    mgr.save(5, state)  # retry overwrites the debris
    assert mgr.all_steps() == [5]
    assert not os.path.exists(debris)
    restored = mgr.restore(5)
    _assert_tree_equal(restored.params, state.params)
    _assert_tree_equal(restored.opt, state.opt)


def test_keep_last_gc_and_in_flight_protection(tmp_path):
    mgr = _mgr(tmp_path, async_save=False, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tiny_state(seed=s))
    assert mgr.all_steps() == [3, 4]
    mgr.keep_last = 1
    mgr._writing.add(3)
    mgr._gc()
    assert mgr.all_steps() == [3, 4]
    mgr._writing.discard(3)
    mgr._gc()
    assert mgr.all_steps() == [4]


def test_bfloat16_leaf_is_refused_by_name(tmp_path):
    state = _tiny_state()
    state.params["w"] = state.params["w"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="params/w is bfloat16"):
        _mgr(tmp_path, async_save=False).save(1, state)


# ------------------------------------------------------------ async save
def test_async_write_error_surfaces_at_wait(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path, async_save=True)
    orig_save = np.save

    def failing_save(path, arr, *a, **k):
        raise OSError("disk full (simulated)")

    monkeypatch.setattr(np, "save", failing_save)
    mgr.save(1, _tiny_state())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # surfaced once, not again
    assert mgr.all_steps() == []
    monkeypatch.setattr(np, "save", orig_save)
    mgr.save(2, _tiny_state())
    mgr.wait()
    assert mgr.all_steps() == [2]


def test_async_write_error_surfaces_at_next_save(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path, async_save=True)
    orig_save = np.save
    monkeypatch.setattr(
        np, "save",
        lambda *a, **k: (_ for _ in ()).throw(OSError("bad sector")))
    mgr.save(1, _tiny_state())
    monkeypatch.setattr(np, "save", orig_save)
    with pytest.raises(OSError, match="bad sector"):
        mgr.save(2, _tiny_state())
    mgr.save(3, _tiny_state())
    mgr.wait()
    assert mgr.all_steps() == [3]


def test_async_save_overlaps_and_spans_cross_threads(tmp_path, monkeypatch):
    """save() returns after the host gather; the writes land on the
    executor: the worker's ``checkpoint:{section}`` spans live on their own
    tracer lanes and end past the save() dispatch."""
    state = _tiny_state()
    orig_save = np.save

    def slow_save(path, arr, *a, **k):
        time.sleep(0.03)
        return orig_save(path, arr, *a, **k)

    monkeypatch.setattr(np, "save", slow_save)
    slowest = 0.03 * max(len(list(layout.flatten(state.params))),
                         len(list(layout.flatten(state.opt))))
    mgr = _mgr(tmp_path, async_save=True)
    with telemetry.Tracer() as trc:
        t0 = time.monotonic()
        mgr.save(1, state)
        dispatch = time.monotonic() - t0
        mgr.wait()
        durable = time.monotonic() - t0
    assert dispatch < slowest <= durable
    spans = {sp.name: sp for sp in trc.finished()}
    main_tid = spans["checkpoint:gather:params"].tid
    assert spans["checkpoint:params"].tid != main_tid
    assert spans["checkpoint:opt"].tid != main_tid
    assert any(sp.name == "checkpoint-durable" and sp.ph == "i"
               for sp in trc.finished())
    assert mgr.all_steps() == [1]


def test_ckpt_metrics_are_declared_and_counted(tmp_path):
    with telemetry.scoped_metrics() as reg:
        mgr = _mgr(tmp_path, async_save=False)
        state = _tiny_state()
        mgr.save(1, state)
        mgr.restore(1)
    nbytes = sum(x.numel() * x.element_size()
                 for _, x in layout.flatten({"o": state.opt,
                                             "p": state.params}))
    assert reg.value("ckpt.saves") == 1 and reg.value("ckpt.restores") == 1
    assert reg.value("ckpt.saved_bytes") == nbytes
    assert reg.value("ckpt.restored_bytes") == nbytes
    assert {n for n in telemetry.DECLARED if n.startswith("ckpt.")} == {
        "ckpt.saves", "ckpt.restores", "ckpt.save_seconds",
        "ckpt.restore_seconds", "ckpt.saved_bytes", "ckpt.restored_bytes",
        "ckpt.write_errors"}


def _trainer_setup(tp=1, pes=1, **tc_kw):
    _, cfg = _cfgs(tp=tp)
    topo = build_topology(cfg, pes)
    tc = tr.TrainConfig(warmup=2, lr=1e-3, **tc_kw)
    masters = trainable(init_params(cfg, topo, 0, device=CPU),
                        param_specs(cfg, topo), topo.cube)
    return cfg, topo, tc, masters, tr.init_opt_state(masters, cfg, topo, tc)


def _batches(cfg, topo, lo, hi, S=32, B=2):
    stream = TokenStream(cfg, DataConfig(seq_len=S, global_batch=B,
                                         vocab_size=cfg.vocab_size))
    return [tr.place_batch(stream.global_batch_at(s), cfg, topo, CPU)
            for s in range(lo, hi)]


def test_trainer_step_does_not_block_on_write(tmp_path, monkeypatch):
    """With slowed disk writes, the train step after a checkpoint dispatch
    finishes before the checkpoint becomes durable (held to the port's own
    spans)."""
    cfg, topo, tc, masters, opt = _trainer_setup()
    n_leaves = len(flat_leaves(masters)) + len(
        list(layout.flatten(opt)))
    orig_save = np.save
    delay = 0.08      # the write (one worker) outlasts the step, loaded

    def slow_save(path, arr, *a, **k):
        time.sleep(delay)
        return orig_save(path, arr, *a, **k)

    monkeypatch.setattr(np, "save", slow_save)
    mgr = _mgr(tmp_path, async_save=True, max_workers=1)
    with telemetry.Tracer() as trc:
        trainer = tr.Trainer(cfg, topo, tc, checkpointer=mgr,
                             dtype=torch.float32)
        trainer.run(masters, opt, _batches(cfg, topo, 0, 3),
                    checkpoint_every=2, log_every=0)
        mgr.wait()
    steps = [sp for sp in trc.finished() if sp.name == "train-step"]
    durable = [sp for sp in trc.finished() if sp.name == "checkpoint-durable"]
    assert len(steps) == 3 and durable
    after = steps[2]
    assert after.ts + after.dur < durable[0].ts
    assert after.dur / 1e6 < n_leaves * delay
    assert mgr.all_steps() == [2]


def test_save_gather_program_hits_lower_cache(tmp_path):
    """The save-side gather program's structural fingerprint is
    step-invariant: the second save reuses the lowered program. Compact
    and full cube leaves both gather."""
    cube = Hypercube.build({"a": 2, "b": 2, "c": 2})
    specs = {"a": ("a", ("b", "c")), "b": (("a", "b"), None), "r": (None,)}
    g = torch.Generator().manual_seed(0)
    globs = [{"a": torch.randn(8, 8, generator=g),
              "b": torch.randn(8, 4, generator=g),
              "r": torch.randn(4, generator=g)} for _ in range(2)]
    placed = [{k: cube.place(v, specs[k]) for k, v in t.items()}
              for t in globs]
    assert placed[0]["r"].shape == (1, 1, 1, 4)        # compact
    placed[1]["a"] = cube.to_cube(globs[1]["a"], specs["a"]).contiguous()
    mgr = _mgr(tmp_path, async_save=False, topo=cube,
               specs={"params": specs, "opt": None})
    mgr.save(1, TrainState(params=placed[0]))
    lowered = program.LOWER_STATS["lowered"]
    mgr.save(2, TrainState(params=placed[1]))
    assert program.LOWER_STATS["lowered"] == lowered
    assert program.LOWER_STATS["cache_hits"] >= 1
    for step, want in ((1, globs[0]), (2, globs[1])):
        got = CheckpointManager(str(tmp_path), device="cpu").restore_params(
            step)
        _assert_tree_equal(got, want)


# ------------------------------------------------- API redesign + shims
def test_deprecated_shims_match_new_surface(tmp_path):
    state = _tiny_state(seed=3)
    new_root, old_root = tmp_path / "new", tmp_path / "old"
    new_mgr = _mgr(new_root, async_save=False)
    new_mgr.save(7, state)
    old_mgr = _mgr(old_root, async_save=False)
    with pytest.warns(DeprecationWarning, match="save\\(step, params"):
        old_mgr.save(7, state.params, state.opt)
    m_new = layout.read_manifest(layout.step_dir(str(new_root), 7))
    m_old = layout.read_manifest(layout.step_dir(str(old_root), 7))
    assert m_new == m_old
    assert m_new["fingerprint"] == layout.fingerprint(m_new["leaves"])

    st = new_mgr.restore(7)
    with pytest.warns(DeprecationWarning, match="restore\\(step\\)"):
        params, opt = old_mgr.restore(7, state.params, state.opt)
    _assert_tree_equal(st.params, params)
    _assert_tree_equal(st.opt, opt)
    p_new = new_mgr.restore_params(7)
    with pytest.warns(DeprecationWarning, match="restore_params"):
        p_old = old_mgr.restore_params(7, state.params)
    _assert_tree_equal(p_new, p_old)
    _assert_tree_equal(p_new, state.params)


def test_fingerprint_validation_catches_architecture_mismatch(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    state = _tiny_state()
    mgr.save(1, state)
    with pytest.raises(ValueError, match="architecture mismatch"):
        with pytest.warns(DeprecationWarning):
            mgr.restore(1, {"w": np.zeros((4, 8), np.float32)}, state.opt)
    bad_shape = {"w": np.zeros((5, 8), np.float32),
                 "b": {"scale": np.zeros(8, np.float32)}}
    with pytest.raises(ValueError, match="does not match the restore"):
        with pytest.warns(DeprecationWarning):
            mgr.restore_params(1, bad_shape)


def test_restore_without_specs_rebuilds_from_manifest(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    state = _tiny_state(seed=11)
    mgr.save(3, state)
    st = _mgr(tmp_path).restore(3)
    _assert_tree_equal(st.params, state.params)
    _assert_tree_equal(st.opt, state.opt)
    _assert_tree_equal(_mgr(tmp_path).restore_params(3), state.params)


def test_restore_defaults_to_cuda(tmp_path):
    """Restore places on CUDA unless the CPU is asked for: without a GPU
    it raises instead of quietly placing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default places there")
    _mgr(tmp_path, async_save=False).save(1, _tiny_state())
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        CheckpointManager(str(tmp_path)).restore(1)


# ------------------------------------------------- files across packages
@pytest.mark.parametrize("layout_", [(1, 1), (1, 2)],
                         ids=lambda l: f"{l[0]}x{l[1]}")
def test_checkpoints_cross_packages_bit_identical(layout_, tmp_path):
    """A JAX save restores in the port, a port save restores in JAX: params
    and int8 AdamW state bit for bit, equal manifests."""
    data, tp = layout_
    jcfg, pcfg = _cfgs(tp=tp)
    jtopo = jax_topology(jcfg, make_mesh((data, tp), ("data", "model")))
    jtc, tc = jax_trainer.TrainConfig(), tr.TrainConfig()
    jp, jo, hp, ho = _random_jax_state(jcfg, jtopo, jtc, seed=1)
    jspecs = {"params": jax_params.param_specs(jcfg, jtopo),
              "opt": jax_trainer.opt_specs(jcfg, jtopo, jtc)}
    ptopo = build_topology(pcfg, data * tp)
    pspecs = {"params": param_specs(pcfg, ptopo),
              "opt": tr.opt_specs(pcfg, ptopo, tc)}
    want = {"/".join(p): np.asarray(x) for p, x in
            layout.flatten({"opt": ho, "params": hp})}

    # JAX -> port
    JaxManager(str(tmp_path / "jax"), topo=jtopo, specs=jspecs,
               async_save=False).save(1, JaxTrainState(params=jp, opt=jo))
    st = CheckpointManager(str(tmp_path / "jax"), topo=ptopo, specs=pspecs,
                           device="cpu").restore(1)
    got = _global({"opt": st.opt, "params": st.params}, pspecs, ptopo.cube)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), w), k
    masters, opt = tr.resume_state(st, pcfg, ptopo, tc)
    direct = trainable(from_jax_params(pcfg, ptopo, hp, device=CPU),
                       pspecs["params"], ptopo.cube)
    _assert_tree_equal(masters, direct)
    _assert_tree_equal(opt, from_jax_opt_state(pcfg, ptopo, ho,
                                               device=CPU))

    # port -> JAX
    port_mgr = CheckpointManager(str(tmp_path / "port"), topo=ptopo,
                                 specs=pspecs, async_save=False)
    port_mgr.save(1, TrainState(params=direct, opt=from_jax_opt_state(
        pcfg, ptopo, ho, device=CPU)))
    jst = JaxManager(str(tmp_path / "port"), topo=jtopo,
                     specs=jspecs).restore(1)
    got = {"/".join(str(k.key) for k in p): np.asarray(x) for p, x in
           jax.tree_util.tree_flatten_with_path(
               {"opt": jst.opt, "params": jst.params})[0]}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k

    m_jax = jax_layout.read_manifest(jax_layout.step_dir(
        str(tmp_path / "jax"), 1))
    m_port = layout.read_manifest(layout.step_dir(str(tmp_path / "port"), 1))
    assert m_port["leaves"] == m_jax["leaves"]
    assert m_port["fingerprint"] == m_jax["fingerprint"]
    assert m_port["cube"] == m_jax["cube"]


def test_full_state_resume_across_shard_counts_raises_in_both(tmp_path):
    """The int8 scales hold one column per shard of a weight's last axis,
    so a full state saved at tp 2 cannot resume at tp 4 nor at tp 1. At tp
    4 the placement itself raises in both packages (2 columns over 4
    shards); at tp 1 both place 2 columns on one PE, and the port's
    ``resume_state`` raises before a step would. A params-only restore is
    elastic in both packages."""
    _, pcfg = _cfgs(tp=2)
    ptopo = build_topology(pcfg, 2)
    tc = tr.TrainConfig()
    masters = trainable(init_params(pcfg, ptopo, 0, device=CPU),
                        param_specs(pcfg, ptopo), ptopo.cube)
    opt = tr.init_opt_state(masters, pcfg, ptopo, tc)
    CheckpointManager(str(tmp_path), topo=ptopo, async_save=False, specs={
        "params": param_specs(pcfg, ptopo),
        "opt": tr.opt_specs(pcfg, ptopo, tc)}).save(
            1, TrainState(params=masters, opt=opt))
    for tp in (4, 1):
        jcfg, qcfg = _cfgs(tp=tp)
        jtopo = jax_topology(jcfg, make_mesh((1, tp), ("data", "model")))
        jmgr = JaxManager(str(tmp_path), topo=jtopo, specs={
            "params": jax_params.param_specs(jcfg, jtopo),
            "opt": jax_trainer.opt_specs(jcfg, jtopo,
                                         jax_trainer.TrainConfig())})
        qtopo = build_topology(qcfg, tp)
        qspecs = {"params": param_specs(qcfg, qtopo),
                  "opt": tr.opt_specs(qcfg, qtopo, tc)}
        qmgr = CheckpointManager(str(tmp_path), topo=qtopo, specs=qspecs,
                                 device="cpu")
        if tp == 4:
            with pytest.raises(ValueError, match="divisible"):
                jmgr.restore(1)
            with pytest.raises(ValueError, match="not divisible by 4"):
                qmgr.restore(1)
        else:
            scale = jmgr.restore(1).opt["mu"]["units"]["p0"]["wq"]["m_s"]
            assert scale.addressable_shards[0].data.shape[-1] == 2
            with pytest.raises(ValueError, match="per-PE shape"):
                tr.resume_state(qmgr.restore(1), qcfg, qtopo, tc)
        assert jax.tree.leaves(jmgr.restore_params(1))
        _assert_tree_equal(qmgr.restore_params(1),
                           init_params(qcfg, qtopo, 0, device=CPU))


# ------------------------------------------------------ reshard-on-restore
def test_scatter_matches_numpy_oracle():
    cube = Hypercube.build({"x": 2, "y": 4})
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    spec = ("x", "y")
    with CommTrace() as trc:
        [placed] = reshard.scatter_to_cube(cube, [torch.from_numpy(x)],
                                           [spec], device="cpu")
    assert [e.primitive for e in trc.events] == ["scatter"]
    want = oracles.reshard(x, cube.dim_sizes, cube.dim_names, spec)
    for coords, block in want.items():
        assert np.array_equal(placed[coords].numpy(), block)
    [back] = reshard.gather_to_host(cube, [placed], [spec])
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("arch", ELASTIC_ARCHS)
def test_elastic_restore_bit_identical_across_topologies(arch, tmp_path):
    """Save on the training cube, restore the params onto a different serve
    cube: one rooted-scatter program with program_id provenance,
    bit-identical to direct init on the target, blocks matching the NumPy
    placement oracle."""
    cfg = configs.get(arch).scaled_for_smoke()
    train_topo = build_topology(cfg, 8)
    serve_topo = build_serve_topology(cfg, 8)
    dims = lambda t: dict(zip(t.cube.dim_names, t.cube.dim_sizes))  # noqa
    assert dims(train_topo) != dims(serve_topo)
    params = init_params(cfg, train_topo, 0, device=CPU)
    mgr = _mgr(tmp_path, async_save=False, topo=train_topo,
               specs={"params": param_specs(cfg, train_topo), "opt": None})
    mgr.save(1, TrainState(params=params))

    serve_specs = param_specs(cfg, serve_topo)
    with CommTrace() as trc:
        restored = mgr.restore_params(1, serve_topo=serve_topo,
                                      specs=serve_specs)
    assert any(e.program_id == "ckpt-restore-params" for e in trc.events)
    assert "ckpt-restore-params" in trc.summary()["programs"]
    direct = init_params(cfg, serve_topo, 0, device=CPU)
    _assert_tree_equal(restored, direct)

    cube = serve_topo.cube
    checked = 0
    for (path, leaf), (_, spec) in zip(leaves(restored),
                                       leaves(serve_specs)):
        if not any(s is not None for s in spec):
            continue
        glob = cube.from_cube(leaf, spec).numpy()
        for coords, block in oracles.reshard(glob, cube.dim_sizes,
                                             cube.dim_names, spec).items():
            assert np.array_equal(leaf[coords].numpy(), block), path
        checked += 1
    assert checked >= 3


# ----------------------------------------------------------------- restart
def test_trainer_loop_with_checkpoint_restart(tmp_path):
    """The port's ``test_trainer_loop_with_checkpoint_restart`` in f32: a
    run saved every 3 steps through a topology-free manager (the trainer
    supplies its topology), restored at step 6 through a manager bound to
    that topology and resumed, gives the uninterrupted run's losses and
    final state bit for bit."""
    cfg, topo, tc, masters, opt = _trainer_setup(tp=2, pes=2)
    batches = _batches(cfg, topo, 0, 8)
    ref = tr.Trainer(cfg, topo, tc, dtype=torch.float32)
    m_ref, o_ref, h_ref = ref.run(masters, opt, batches, log_every=0)

    cfg, topo, tc, masters, opt = _trainer_setup(tp=2, pes=2)
    mgr = _mgr(tmp_path, async_save=False)
    t1 = tr.Trainer(cfg, topo, tc, checkpointer=mgr, dtype=torch.float32)
    t1.run(masters, opt, batches[:6], checkpoint_every=3, log_every=0)
    assert mgr.all_steps() == [3, 6] and mgr.latest_step() == 6
    st = _mgr(tmp_path, topo=topo, specs={
        "params": param_specs(cfg, topo),
        "opt": tr.opt_specs(cfg, topo, tc)}).restore(6)
    m2, o2 = tr.resume_state(st, cfg, topo, tc)
    assert int(o2["step"]) == 6
    t2 = tr.Trainer(cfg, topo, tc, checkpointer=mgr, dtype=torch.float32)
    m3, o3, h3 = t2.run(m2, o2, batches[6:], start_step=6, log_every=0)
    assert [h["loss"] for h in h3] == [h["loss"] for h in h_ref[6:]]
    _assert_tree_equal(m3, m_ref)
    _assert_tree_equal(o3, o_ref)


def test_launcher_ckpt_dir_every_and_resume(tmp_path, capsys):
    """``--ckpt-dir --ckpt-every --resume`` through ``main``: a run of 6
    steps saves at 2, 4 and 6; with step 6 removed, ``--resume`` restores
    step 4, trains steps 5-6 and ends on the first run's state bit for
    bit."""
    d = str(tmp_path / "ckpts")
    argv = ["--arch", ARCH, "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "16", "--warmup", "2", "--device", "cpu", "--pes", "2",
            "--fp32-moments", "--ckpt-dir", d, "--ckpt-every", "2"]
    first = launcher.main(argv)
    assert first["ckpt"].all_steps() == [2, 4, 6]
    shutil.rmtree(layout.step_dir(d, 6))
    second = launcher.main(argv + ["--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert second["start"] == 4 and len(second["history"]) == 2
    assert [h["loss"] for h in second["history"]] == \
        [h["loss"] for h in first["history"][4:]]
    _assert_tree_equal(second["params"], first["params"])
    _assert_tree_equal(second["opt"], first["opt"])
    assert second["ckpt"].all_steps() == [2, 4, 6]
    done = launcher.main(argv + ["--resume"])
    assert done["start"] == 6 and done["history"] == []


# ----------------------------------------------------- restore-for-serving
def test_restore_for_serving(tmp_path):
    """Params saved on the train cube restore onto the serve topology (no
    opt-state skeleton) and the engine decodes with them, the tokens of
    direct params; an architecture mismatch is a clear error."""
    _, cfg = _cfgs(tp=2)
    train_topo = build_topology(cfg, 2)
    params = init_params(cfg, train_topo, 4, device=CPU)
    masters = trainable(params, param_specs(cfg, train_topo),
                        train_topo.cube)
    tc = tr.TrainConfig()
    mgr = _mgr(tmp_path, async_save=False, topo=train_topo,
               specs={"params": param_specs(cfg, train_topo),
                      "opt": tr.opt_specs(cfg, train_topo, tc)})
    mgr.save(7, TrainState(params=masters, opt=tr.init_opt_state(
        masters, cfg, train_topo, tc)))

    stopo = build_serve_topology(cfg, 2)
    sspecs = param_specs(cfg, stopo)
    restored = mgr.restore_params(7, serve_topo=stopo, specs=sspecs)
    _assert_tree_equal(restored, init_params(cfg, stopo, 4, device=CPU))
    plan = make_serve_plan(cfg, stopo, S_ctx=16, global_batch=2)

    def tokens(p):
        eng = ServeEngine(cfg, stopo, plan, p, dtype=torch.float32,
                          device="cpu")
        m = eng.run([Request(rid=0, prompt=[5, 6, 7], max_new=3),
                     Request(rid=1, prompt=[9, 2], max_new=4)])
        return {r.rid: list(r.out_tokens) for r in m["finished"]}

    got = tokens(restored)
    assert [len(got[0]), len(got[1])] == [3, 4]
    assert got == tokens(init_params(cfg, stopo, 4, device=CPU))
    with pytest.raises(ValueError, match="params leaves"):
        with pytest.warns(DeprecationWarning):
            mgr.restore_params(7, {"w": np.zeros(2)})


# ---------------------------------------------------------- error feedback
def test_error_feedback_round_trips_per_pod_and_equals_jax(tmp_path):
    """On pod2x4x2 (2 pods x data 4 x tp 2) a compressed-gradient step
    fills pod-distinct error buffers. A topology-bound save keeps every
    pod's buffer as the reference's global ``(n_slow, *shape)`` array, a
    restore on the same cube gives each PE's buffer back bit for bit, and
    the JAX manager reads the same ``ef`` leaves; the specs are JAX's
    ``error_feedback_specs``."""
    _, cfg = _cfgs(tp=2)
    tc = tr.TrainConfig(warmup=2, lr=1e-3, compress_pod_grads=True)
    topo = build_topology(cfg, 16, pods=2)
    assert dict(zip(topo.cube.dim_names, topo.cube.dim_sizes)) == {
        "pod": 2, "data": 4, "tp": 2}
    masters = trainable(init_params(cfg, topo, 0, device=CPU),
                        param_specs(cfg, topo), topo.cube)
    opt = tr.init_opt_state(masters, cfg, topo, tc)
    step = tr.make_train_step(cfg, topo, tc, dtype=torch.float32)
    masters, opt, _ = step(masters, opt, _batches(cfg, topo, 0, 1, S=16,
                                                  B=8)[0])
    ospecs = tr.opt_specs(cfg, topo, tc)
    assert sorted(opt["ef"]) == sorted(ospecs["ef"]) and opt["ef"]
    for key, buf in opt["ef"].items():
        assert float(buf.abs().max()) > 0, key
        assert not torch.equal(buf[0], buf[1]), key       # pod-distinct
    specs = {"params": param_specs(cfg, topo), "opt": ospecs}
    mgr = _mgr(tmp_path, async_save=False, topo=topo, specs=specs)
    mgr.save(1, TrainState(params=masters, opt=opt))
    _, opt2 = tr.resume_state(mgr.restore(1), cfg, topo, tc)
    assert sorted(opt2["ef"]) == sorted(opt["ef"])
    for key in opt["ef"]:
        assert torch.equal(opt2["ef"][key], opt["ef"][key]), key

    jst = JaxManager(str(tmp_path)).restore(1)
    shapes = [d.shape for d in flat_leaves(param_defs(cfg, topo))]
    for key, buf in opt["ef"].items():
        glob = np.asarray(jst.opt["ef"][key])
        assert glob.shape == (2,) + tuple(shapes[int(key)])
        for pod in range(2):    # each pod's buffer as the cube holds it
            assert np.array_equal(
                glob[pod], topo.cube.from_cube(
                    buf, ospecs["ef"][key])[pod].numpy()), key

    jcfg, _ = _cfgs(tp=2)
    jtopo = jax_topology(jcfg, make_mesh((2, 2, 2),
                                         ("pod", "data", "model")))
    ptopo8 = build_topology(cfg, 8, pods=2)
    jef = jax_trainer.error_feedback_specs(jcfg, jtopo,
                                           jax_trainer.TrainConfig())
    norm = lambda s: tuple(  # noqa: E731 - a one-name tuple is the name
        e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in s)
    assert {k: norm(v) for k, v in jef.items()} == {
        k: norm(v) for k, v in tr.error_feedback_specs(cfg, ptopo8).items()}


# --------------------------------------------------------------------- HF
def _jax_params_np(arch=ARCH):
    jcfg, pcfg = _cfgs(arch)
    jtopo = jax_topology(jcfg, make_mesh((1, 1), ("data", "model")))
    hp = jax.tree.map(np.asarray, jax_params.init_params(jcfg, jtopo, 0))
    return jcfg, pcfg, jtopo, hp


def _same_tree(port_tree, jax_tree):
    got = {"/".join(p): x for p, x in layout.flatten(port_tree)}
    want = {"/".join(p): np.asarray(x)
            for p, x in layout.flatten(jax_tree)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        assert np.array_equal(g.numpy(), w), k


def test_hf_roundtrip_qwen3(tmp_path):
    _, cfg, _, hp = _jax_params_np()
    topo = build_topology(cfg, 1)
    params = tree_map(torch.from_numpy, hp)
    sd = hf_import.export_state_dict(params, cfg)
    assert "lm_head.weight" in sd
    st, pt = str(tmp_path / "model.safetensors"), str(
        tmp_path / "pytorch_model.bin")
    hf_import.write_safetensors(st, sd)
    hf_import.write_pytorch_bin(pt, sd)
    for path in (st, pt):
        back = hf_import.import_state_dict(hf_import.read_state_dict(path),
                                           cfg, topo)
        _same_tree(back, hp)


@pytest.mark.parametrize("fmt", ["f32_safetensors", "bf16_safetensors",
                                 "jax_bin", "port_bin"])
def test_hf_import_equals_jax_import(fmt, tmp_path):
    """The port's import of a file equals the JAX package's import of the
    same file, bit for bit: F32 and BF16 safetensors, and a
    pytorch_model.bin written by each package (each reader takes the other
    package's file)."""
    jcfg, pcfg, jtopo, hp = _jax_params_np()
    sd = jax_hf.export_state_dict(hp, jcfg)
    path = str(tmp_path / ("model.safetensors" if "safetensors" in fmt
                           else "pytorch_model.bin"))
    if fmt == "f32_safetensors":
        jax_hf.write_safetensors(path, sd)
    elif fmt == "bf16_safetensors":
        hf_import.write_safetensors(path, {
            k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in sd.items()})
        assert jax_hf.read_safetensors(path)[
            "model.norm.weight"].dtype.name == "bfloat16"
    elif fmt == "jax_bin":
        jax_hf.write_pytorch_bin(path, sd)
    else:
        hf_import.write_pytorch_bin(path, sd)
    want = jax_hf.import_state_dict(jax_hf.read_state_dict(path), jcfg,
                                    jtopo)
    got = hf_import.import_state_dict(hf_import.read_state_dict(path), pcfg,
                                      build_topology(pcfg, 1))
    _same_tree(got, want)
    if fmt != "bf16_safetensors":
        _same_tree(got, hp)


def test_hf_import_moe_equals_jax():
    """qwen2-moe's expert, shared-expert and router keys (router columns
    padded with ROUTER_PAD, padding experts zero) map as in the
    reference."""
    jcfg, pcfg = (dataclasses.replace(c, n_experts=3, ep=2)
                  for c in _cfgs("qwen2-moe-a2.7b"))
    assert pcfg.n_experts_padded == 4
    rng = np.random.default_rng(5)
    D, H, KV, hd = pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim
    Fe, Fs = pcfg.d_ff_expert, pcfg.n_shared_experts * pcfg.d_ff_expert

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(pcfg.vocab_size, D),
          "model.norm.weight": w(D), "lm_head.weight": w(pcfg.vocab_size, D)}
    for layer in range(pcfg.n_layers):
        pre = f"model.layers.{layer}."
        sd.update({pre + "input_layernorm.weight": w(D),
                   pre + "post_attention_layernorm.weight": w(D),
                   pre + "self_attn.q_proj.weight": w(H * hd, D),
                   pre + "self_attn.k_proj.weight": w(KV * hd, D),
                   pre + "self_attn.v_proj.weight": w(KV * hd, D),
                   pre + "self_attn.o_proj.weight": w(D, H * hd),
                   pre + "mlp.gate.weight": w(pcfg.n_experts, D),
                   pre + "mlp.shared_expert.gate_proj.weight": w(Fs, D),
                   pre + "mlp.shared_expert.up_proj.weight": w(Fs, D),
                   pre + "mlp.shared_expert.down_proj.weight": w(D, Fs),
                   pre + "mlp.shared_expert_gate.weight": w(1, D)})
        if pcfg.qk_norm:
            sd[pre + "self_attn.q_norm.weight"] = w(hd)
            sd[pre + "self_attn.k_norm.weight"] = w(hd)
        for e in range(pcfg.n_experts):
            sd[pre + f"mlp.experts.{e}.gate_proj.weight"] = w(Fe, D)
            sd[pre + f"mlp.experts.{e}.up_proj.weight"] = w(Fe, D)
            sd[pre + f"mlp.experts.{e}.down_proj.weight"] = w(D, Fe)
    want = jax_hf.import_state_dict(dict(sd), jcfg)
    got = hf_import.import_state_dict(dict(sd), pcfg)
    _same_tree(got, want)
    assert float(got["units"]["p0"]["router"][..., -1].max()) == \
        hf_import.ROUTER_PAD


def test_hf_import_rejects_unmapped_keys():
    _, cfg, _, hp = _jax_params_np()
    topo = build_topology(cfg, 1)
    sd = {k: torch.from_numpy(v) for k, v in
          jax_hf.export_state_dict(hp, _cfgs()[0]).items()}
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.zeros(4)
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(4)
    with pytest.raises(ValueError, match="no mapping"):
        hf_import.import_state_dict(sd, cfg, topo)
    _same_tree(hf_import.import_state_dict(sd, cfg, topo, strict=False), hp)


def test_hf_import_unsupported_architectures():
    cfg = configs.get("rwkv6-7b").scaled_for_smoke()
    with pytest.raises(hf_import.UnsupportedArchitecture,
                       match="no[\\s\\S]*mapping"):
        hf_import.import_state_dict({}, cfg)
    with pytest.raises(NotImplementedError):
        hf_import.export_state_dict({}, cfg)


def test_import_checkpoint_places_through_hf_import_program(tmp_path):
    """``import_checkpoint`` onto a 2-PE serve cube: one rooted-scatter
    program named ``hf-import``, the leaves direct init's layout of the
    imported values."""
    _, cfg1 = _cfgs()
    src = build_topology(cfg1, 1)
    tree = to_global(init_params(cfg1, src, 2, device=CPU),
                     param_specs(cfg1, src), src.cube)
    cfg = dataclasses.replace(cfg1, tp=2)
    path = str(tmp_path / "model.safetensors")
    hf_import.write_safetensors(path, hf_import.export_state_dict(tree, cfg))
    stopo = build_serve_topology(cfg, 2)
    with CommTrace() as trc:
        placed = hf_import.import_checkpoint(
            path, cfg, stopo, specs=param_specs(cfg, stopo), device="cpu")
    assert {e.program_id for e in trc.events} == {"hf-import"}
    _assert_tree_equal(placed, init_params(cfg, stopo, 2, device=CPU))
