"""The port's low-precision modes (``LOWP`` 1 / 2) at the model level,
held against the JAX package on the CPU in bf16 (the reference's own
compute dtype), with both packages' ``LOWP`` set by ``monkeypatch``: the
smoke qwen3 and gemma3 (12 layers, so its global layers run)
``forward_logits`` at 1 and 2 PEs under mode 2, within the bf16 forward
tolerance of the RWKV6 tests (an f32 leaf of a bf16 run: one bf16 ulp at
max(1, max|ref|)); their 1-PE gradients of ``loss_shard`` under modes 1
and 2 against ``jax.grad`` of the reference's, within ``GRAD_TOL`` of
each leaf's own max (0.008-0.013 read; mode 0 reads up to 0.017: bf16
noise, not the mode). The attention itself is ``tests/test_torch_lowp.py``.

The reference's ``loss_shard`` differentiates under ``shard_map(...,
check_vma=False)`` only with ``compat.pvary`` set to the identity, as in
``tests/test_torch_train.py`` (on one PE it is the identity in value and
gradient).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.compat as jax_compat
import repro.models.blocks as jax_blocks
import repro.models.layers as jax_layers
import repro.models.lm as jax_lm
import repro.models.params as jax_params
import repro.models.serving as jax_serving
from repro.compat import shard_map
from repro.configs import get as jax_get
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenStream as JaxTokenStream
from repro.launch.mesh import make_mesh
from repro.models.topology import build_topology as jax_topology
from repro.runtime.trainer import input_batch_specs

from repro_torch import configs
from repro_torch.core import program
from repro_torch.models import layers
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    compact, flat_leaves, from_jax_params, param_specs, to_global, tree_map,
    trainable)
from repro_torch.models.topology import build_topology
from repro_torch.runtime import trainer as tr

BF16_F32_TOL = 2.0 ** -7   # an f32 leaf (the logits) of a bf16 run
GRAD_TOL = 5e-2       # x each leaf's own max: the bf16 backward's gate
CPU = torch.device("cpu")


@pytest.fixture
def lowp(monkeypatch):
    """Set both packages' mode for one test: ``lowp(mode)``."""
    def set_mode(mode):
        monkeypatch.setattr(jax_layers, "LOWP", mode)
        monkeypatch.setattr(layers, "LOWP", mode)
    return set_mode


@pytest.fixture
def bf16_reference(monkeypatch):
    """The JAX package's own compute dtype, bf16, whatever another test
    module set it to when it was imported."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.bfloat16)


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    program.clear_lower_cache()
    for k in program.LOWER_STATS:
        program.LOWER_STATS[k] = 0


MODELS = {"qwen3": ("qwen3-1.7b", {}),
          "gemma3": ("gemma3-1b", {"n_layers": 12})}


def _cfgs(model, pes):
    arch, over = MODELS[model]
    return (dataclasses.replace(jax_get(arch).scaled_for_smoke(), tp=pes,
                                **over),
            dataclasses.replace(configs.get(arch).scaled_for_smoke(), tp=pes,
                                **over))


@pytest.mark.parametrize("pes", [1, 2])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_logits_match_jax_under_lowp2(bf16_reference, lowp, model,
                                              pes):
    jcfg, pcfg = _cfgs(model, pes)
    lowp(2)
    B, S = 2, 24
    tokens = np.random.RandomState(5).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jtopo = jax_topology(jcfg, make_mesh((1, pes), ("data", "model")))
    jparams = jax_params.init_params(jcfg, jtopo, seed=2)
    fwd = jax.jit(shard_map(
        jax_lm.Model(jcfg, jtopo).forward_logits, mesh=jtopo.cube.mesh,
        in_specs=(jax_params.param_specs(jcfg, jtopo),
                  input_batch_specs(jcfg, jtopo)),
        out_specs=P(jtopo.dp, None, jtopo.tp), check_vma=False))
    want = np.asarray(fwd(jparams, {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(tokens)}))
    topo = build_topology(pcfg, pes)
    params = from_jax_params(pcfg, topo, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    cube = topo.cube
    logits = Model(pcfg, topo, dtype=torch.bfloat16).forward_logits(
        params, {"tokens": cube.to_cube(torch.from_numpy(tokens).long(),
                                        (topo.dp, None))})
    got = cube.from_cube(logits, (topo.dp, None, topo.tp))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    tol = BF16_F32_TOL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= tol


@pytest.mark.parametrize("mode", (1, 2))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_single_pe_grads_match_jax_grad_under_lowp(bf16_reference, lowp,
                                                   monkeypatch, model,
                                                   mode):
    monkeypatch.setattr(jax_compat, "pvary", lambda x, axes: x)
    jcfg, pcfg = _cfgs(model, 1)
    lowp(mode)
    jtopo = jax_topology(jcfg, make_mesh((1, 1), ("data", "model")))
    jparams = jax_params.init_params(jcfg, jtopo, seed=0)
    b = JaxTokenStream(jcfg, JaxDataConfig(
        seq_len=24, global_batch=2, vocab_size=jcfg.vocab_size, seed=0,
        doc_len_mean=8)).global_batch_at(0)
    jmodel = jax_lm.Model(jcfg, jtopo)
    specs = jax_params.param_specs(jcfg, jtopo)
    grad = jax.jit(shard_map(
        lambda p, bb: jax.grad(lambda q: jmodel.loss_shard(q, bb)[0])(p),
        mesh=jtopo.cube.mesh, in_specs=(specs, input_batch_specs(jcfg,
                                                                  jtopo)),
        out_specs=specs, check_vma=False))
    want = jax.tree.leaves(grad(jparams, {k: jnp.asarray(v)
                                          for k, v in b.items()}))
    topo = build_topology(pcfg, 1)
    pspecs = param_specs(pcfg, topo)
    masters = trainable(from_jax_params(
        pcfg, topo, jax.tree.map(np.asarray, jparams), device=CPU), pspecs,
        topo.cube)
    step = tr.make_train_step(pcfg, topo, tr.TrainConfig(),
                              dtype=torch.bfloat16)
    _, _, raw = step.fwd_bwd(masters, tr.place_batch(b, pcfg, topo, CPU))
    got = flat_leaves(to_global(tree_map(
        lambda g, s: compact(g, s, topo.cube), step.sync(raw, {}), pspecs),
        pspecs, topo.cube))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.float().numpy() - w).max() <= GRAD_TOL * max(
            np.abs(w).max(), 1e-30)
