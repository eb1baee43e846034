"""jamba-1.5-large's bf16 decode against its own bf16 forward, in the port
and in the JAX package, on the CPU.

On the card the port's bf16 decode of jamba (one unit at d_model 4,096)
reads 0.47 of max from its bf16 forward, where f32 reads 7e-6: the two
paths round their bf16 products in other orders (a one-token GEMM against
a whole-sequence one, the Mamba step against the chunked scan), and the
differences grow through the layers. Whether the port's gap is bf16's or
a fault of the port is settled against the JAX package's own gap on the
same weights (``from_jax_params``) and tokens, with the JAX compute dtype
pinned to bf16 by ``monkeypatch``.

The size: one unit of 8 layers (``mmmmAmmm``, the expert capacity at
n_experts / top_k so that no choice drops in either path) at d_model
1,024, 2 sequences of 16 tokens, each token teacher-forced through
``decode_shard`` from an empty cache and every step's logits held to the
forward's at that position. Below d_model 1,024 (smoke width 64 up to
512) the port's two paths give the same bits on the CPU: its bf16 GEMMs
sum a row alike at any row count there, and the Mamba step's f32
differences from the scan stay under bf16's rounding of the residual
stream. So do 12 prompt tokens through ``prefill_shard`` and 4 decode
steps at 1,024; 8 decode steps from an empty cache still do, 12 part.
The gap is max |decode - forward| / max |forward| over the 16 positions;
read here: port 6.5e-3, JAX 7.3e-3 (at 24 positions 8.5e-3 and 6.4e-3).
The port's must lie within 1.5x of JAX's either way."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

import repro.models.blocks as jax_blocks
import repro.models.lm as jax_lm
import repro.models.params as jax_params
import repro.models.serving as jax_serving
from repro.compat import shard_map
from repro.configs import get as jax_get
from repro.launch.mesh import make_mesh
from repro.models.topology import build_topology as jax_topology
from repro.runtime.trainer import input_batch_specs

from repro_torch import configs
from repro_torch.models.lm import Model
from repro_torch.models.params import from_jax_params
from repro_torch.models.serving import Server, init_cache, make_serve_plan
from repro_torch.models.topology import build_serve_topology, build_topology

ARCH = "jamba-1.5-large"
CPU = torch.device("cpu")
D_MODEL, S, B = 1024, 16, 2
RATIO = 1.5


def _cfgs():
    def cut(cfg):
        cfg = cfg.scaled_for_smoke()
        return dataclasses.replace(
            cfg, n_layers=8, d_model=D_MODEL, ep=1, etp=1,
            capacity_factor=cfg.n_experts / cfg.top_k)
    return cut(jax_get(ARCH)), cut(configs.get(ARCH))


def _jax_paths(jcfg, jtopo, jparams, tokens):
    """JAX's bf16 decode loop from an empty cache and its forward at 1 PE:
    logits (B, S, V) of each."""
    pspecs = jax_params.param_specs(jcfg, jtopo)
    fwd = jax.jit(shard_map(
        jax_lm.Model(jcfg, jtopo).forward_logits, mesh=jtopo.cube.mesh,
        in_specs=(pspecs, input_batch_specs(jcfg, jtopo)),
        out_specs=P(jtopo.dp, None, jtopo.tp), check_vma=False))
    full = fwd(jparams, {"tokens": jnp.asarray(tokens),
                         "labels": jnp.asarray(tokens)})
    plan = jax_serving.make_serve_plan(jcfg, jtopo, S_ctx=S, global_batch=B)
    cspecs = jax_serving.cache_specs(jcfg, jtopo, plan)
    step = jax.jit(shard_map(
        jax_serving.Server(jcfg, jtopo, plan).decode_shard,
        mesh=jtopo.cube.mesh, in_specs=(pspecs, cspecs, P(None), P(None)),
        out_specs=(P(None, jtopo.tp), cspecs), check_vma=False))
    cache, dec = jax_serving.init_cache(jcfg, jtopo, plan), []
    for t in range(S):
        logits, cache = step(jparams, cache, jnp.asarray(tokens[:, t]),
                             jnp.full((B,), t, jnp.int32))
        dec.append(np.asarray(logits.astype(jnp.float32)))
    return np.stack(dec, 1), np.asarray(full.astype(jnp.float32))


def _port_paths(pcfg, host_params, tokens):
    """The port's bf16 decode loop from an empty cache and its forward at
    1 PE: logits (B, S, V) of each."""
    topo, ftopo = build_serve_topology(pcfg, 1), build_topology(pcfg, 1)
    assert ftopo.cube == topo.cube
    cube = topo.cube
    params = from_jax_params(pcfg, topo, host_params, device=CPU)
    plan = make_serve_plan(pcfg, topo, S_ctx=S, global_batch=B)
    server = Server(pcfg, topo, plan, dtype=torch.bfloat16)
    with torch.no_grad():
        full = Model(pcfg, ftopo, dtype=torch.bfloat16).forward_logits(
            params, {"tokens": cube.to_cube(torch.from_numpy(tokens).long(),
                                            (ftopo.dp, None))})
        cache = init_cache(pcfg, topo, plan, dtype=torch.bfloat16,
                           device=CPU)
        dec = []
        for t in range(S):
            logits, cache = server.decode_shard(
                params, cache,
                cube.to_cube(torch.from_numpy(tokens[:, t]).long(), (None,)),
                cube.to_cube(torch.full((B,), t), (None,)))
            dec.append(cube.from_cube(logits, (None, topo.tp)).float())
    full = cube.from_cube(full, (ftopo.dp, None, ftopo.tp)).float()
    return torch.stack(dec, 1).numpy(), full.numpy()


def _gap(dec, full) -> float:
    return float(np.abs(dec - full).max() / np.abs(full).max())


def test_bf16_decode_vs_forward_gap_matches_jax(monkeypatch):
    """The port's bf16 decode-vs-forward gap within RATIO of JAX's, where
    both packages' paths round apart (module docstring)."""
    for mod in (jax_params, jax_blocks, jax_lm, jax_serving):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.bfloat16)
    jcfg, pcfg = _cfgs()
    jtopo = jax_topology(jcfg, make_mesh((1, 1), ("data", "model")))
    jparams = jax_params.init_params(jcfg, jtopo, seed=1)
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jax_gap = _gap(*_jax_paths(jcfg, jtopo, jparams, tokens))
    port_gap = _gap(*_port_paths(pcfg, jax.tree.map(np.asarray, jparams),
                                 tokens))
    print(f"jamba bf16 decode vs forward, one unit at d_model {D_MODEL}: "
          f"JAX {jax_gap:.6g}, port {port_gap:.6g}")
    assert jax_gap > 0 and port_gap > 0
    assert jax_gap / RATIO <= port_gap <= RATIO * jax_gap
