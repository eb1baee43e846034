"""Training through ``fused_comm`` on the port, and the context-parallel
refusal of its loss, on the CPU.

``fused_comm`` reroutes the attention block's and the dense FFN's tp
collectives through the fused ring flows (``ag_prologue`` gathers with the
norm in its ring, ``rs_epilogue`` reduce-scatters the out-projection); at
cp 1 attention runs the full flash form, so a train step differentiates
them. qwen3's smoke config at tp 2 (2 PEs, f32): the fused step's synced
gradients equal the unfused step's within ``GRAD_TOL`` x each leaf's own
max|grad|, its loss equals theirs, and its ``CommTrace`` shows both fused
flows. The partial form (ring attention over cp) has no training path:
``loss_shard`` refuses a cp topology, as the JAX package's asserts
(``src/repro/models/lm.py:216``); the JAX package has no fused-comm
training at cp > 1 either.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models.lm as jax_lm
from repro.configs import get as jax_get
from repro.launch.mesh import make_mesh
from repro.models.topology import build_topology as jax_topology
from repro.testing.substrate import ensure_virtual_devices

from repro_torch import configs
from repro_torch.core import program
from repro_torch.core.comm import CommTrace
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.models.lm import Model
from repro_torch.models.params import (
    compact, flat_leaves, init_params, leaves, param_specs, trainable,
    tree_map)
from repro_torch.models.topology import build_topology
from repro_torch.runtime import trainer as tr

ARCH = "qwen3-1.7b"
CPU = torch.device("cpu")
GRAD_TOL = 1e-6     # x each leaf's own max|grad|, f32
LOSS_TOL = 1e-6     # relative, f32


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    program.clear_lower_cache()
    for k in program.LOWER_STATS:
        program.LOWER_STATS[k] = 0


def _step_grads(fused: bool, masters, topo, batch):
    cfg = dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), tp=2,
                              fused_comm=fused)
    step = tr.make_train_step(cfg, topo, tr.TrainConfig(),
                              dtype=torch.float32)
    with CommTrace() as trace:
        loss, _, raw = step.fwd_bwd(masters, batch)
        synced = step.sync(raw, {})
    specs = param_specs(cfg, topo)
    grads = tree_map(lambda g, s: compact(g, s, topo.cube), synced, specs)
    return float(loss.reshape(-1)[0]), grads, {e.flow for e in trace.events}


def test_fused_comm_train_step_grads_equal_unfused():
    cfg = dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), tp=2)
    topo = build_topology(cfg, 2)
    masters = trainable(init_params(cfg, topo, 0, device=CPU),
                        param_specs(cfg, topo), topo.cube)
    batch = tr.place_batch(TokenStream(cfg, DataConfig(
        seq_len=32, global_batch=2, vocab_size=cfg.vocab_size,
        seed=0)).global_batch_at(0), cfg, topo, CPU)
    loss, ref, flows = _step_grads(False, masters, topo, batch)
    f_loss, got, f_flows = _step_grads(True, masters, topo, batch)
    assert {"ag_prologue", "rs_epilogue"} <= f_flows
    assert not {"ag_prologue", "rs_epilogue"} & flows
    assert abs(f_loss - loss) <= LOSS_TOL * abs(loss)
    for (path, r), g in zip(leaves(ref), flat_leaves(got)):
        peak = float(r.abs().max())
        assert peak > 0, path
        assert float((g - r).abs().max()) <= GRAD_TOL * peak, path


@pytest.mark.parametrize("fused", [False, True])
def test_loss_shard_refuses_context_parallelism(fused):
    """qwen3 smoke at tp 2 on 8 PEs with global batch 2 (data 2, cp 2):
    the port's loss raises, and the JAX package's ``loss_shard`` asserts
    on the same topology."""
    ensure_virtual_devices(8)
    cfg = dataclasses.replace(configs.get(ARCH).scaled_for_smoke(), tp=2,
                              fused_comm=fused)
    topo = build_topology(cfg, 8, global_batch=2)
    assert topo.cp == ("cp",)
    params = init_params(cfg, topo, 0, device=CPU)
    b = TokenStream(cfg, DataConfig(seq_len=32, global_batch=2,
                                    vocab_size=cfg.vocab_size,
                                    seed=0)).global_batch_at(0)
    with pytest.raises(ValueError, match="context parallelism"):
        Model(cfg, topo, dtype=torch.float32).loss_shard(
            params, tr.place_batch(b, cfg, topo, CPU))
    jcfg = dataclasses.replace(jax_get(ARCH).scaled_for_smoke(), tp=2,
                               fused_comm=fused)
    jtopo = jax_topology(jcfg, make_mesh((4, 2), ("data", "model")),
                         global_batch=2)
    assert jtopo.cp
    with pytest.raises(AssertionError, match="context parallelism"):
        jax_lm.Model(jcfg, jtopo).loss_shard(None, {
            k: np.asarray(v) for k, v in b.items()})
