"""Parameter definitions: global shapes, shardings, init, and the weight
converter from the JAX package.

The counterpart of ``repro.models.params``. A spec is a tuple with one entry
per array axis (None / dim name / tuple of dim names), the port's
``PartitionSpec``. Parameters live on the cube: each leaf is a cube tensor
``(*cube.dim_sizes, *local_shape)`` holding every PE's block of the global
array under its spec (``Hypercube.to_cube``); dims a spec does not name
replicate as read-only broadcast views, so the cube holds the global bytes
once. Master weights are f32; ``blocks.gather_params`` casts each layer to
the compute dtype on use.

Ported defs: attention, dense FFN and MoE FFN (the dense-decoder and MoE
families), and RWKV6 time-mix and channel-mix. The other mixers and FFNs
raise until their slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.models.config import (
    ModelConfig, ATTN, DENSE, MOE, RWKV, RWKVCM)
from repro_torch.models.topology import Topology

MASTER_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    spec: tuple
    init: str = "normal"       # normal | zeros | ones | out_proj | embed
                               # | decay
    dtype: Any = MASTER_DTYPE


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def kv_is_sharded(cfg: ModelConfig, topo: Topology) -> bool:
    t = topo.tp_size
    return cfg.n_kv_heads >= t and cfg.n_kv_heads % t == 0


def vocab_padded(cfg: ModelConfig, topo: Topology) -> int:
    return _round_up(cfg.vocab_size, topo.tp_size)


# --------------------------------------------------------------------- defs
def _attn_defs(cfg, topo):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tp = topo.tp
    kv_spec = ("data", tp) if kv_is_sharded(cfg, topo) else ("data", None)
    d = {
        "ln": ParamDef((D,), ("data",), "zeros"),
        "wq": ParamDef((D, H * hd), ("data", tp)),
        "wkv": ParamDef((D, 2 * KV * hd), kv_spec),
        "wo": ParamDef((H * hd, D), (tp, "data"), "out_proj"),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((hd,), (None,), "zeros")
        d["k_norm"] = ParamDef((hd,), (None,), "zeros")
    return d


def _dense_ffn_defs(cfg, topo):
    D, F = cfg.d_model, cfg.d_ff
    tp = topo.tp
    return {
        "fln": ParamDef((D,), ("data",), "zeros"),
        "wg": ParamDef((D, F), ("data", tp)),
        "wu": ParamDef((D, F), ("data", tp)),
        "wd": ParamDef((F, D), (tp, "data"), "out_proj"),
    }


def _moe_ffn_defs(cfg, topo):
    D, Fe = cfg.d_model, cfg.d_ff_expert
    Ep = cfg.n_experts_padded
    ep, etp = topo.ep, topo.etp
    d = {
        "fln": ParamDef((D,), ("data",), "zeros"),
        "router": ParamDef((D, Ep), ("data", None)),
        "we_g": ParamDef((Ep, D, Fe), (ep, "data", etp)),
        "we_u": ParamDef((Ep, D, Fe), (ep, "data", etp)),
        "we_d": ParamDef((Ep, Fe, D), (ep, etp, "data"), "out_proj"),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        d["ws_g"] = ParamDef((D, Fs), ("data", None))
        d["ws_u"] = ParamDef((D, Fs), ("data", None))
        d["ws_d"] = ParamDef((Fs, D), (None, "data"), "out_proj")
    return d


def _rwkv_defs(cfg, topo):
    D = cfg.d_model
    tp = topo.tp
    lora = 64
    return {
        "ln": ParamDef((D,), ("data",), "zeros"),
        "mu": ParamDef((5, D), (None, "data")),
        "wr": ParamDef((D, D), ("data", tp)),
        "wk": ParamDef((D, D), ("data", tp)),
        "wv": ParamDef((D, D), ("data", tp)),
        "wg": ParamDef((D, D), ("data", tp)),
        "w_lora_a": ParamDef((D, lora), ("data", None)),
        "w_lora_b": ParamDef((lora, D), (None, tp)),
        "decay_w0": ParamDef((D,), (tp,), "decay"),
        "bonus_u": ParamDef((D,), (tp,)),
        "wo": ParamDef((D, D), (tp, "data"), "out_proj"),
    }


def _rwkvcm_defs(cfg, topo):
    D, F = cfg.d_model, cfg.d_ff
    tp = topo.tp
    return {
        "fln": ParamDef((D,), ("data",), "zeros"),
        "cm_mu": ParamDef((2, D), (None, "data")),
        "cm_r": ParamDef((D, D), ("data", None)),
        "cm_k": ParamDef((D, F), ("data", tp)),
        "cm_v": ParamDef((F, D), (tp, "data"), "out_proj"),
    }


_MIXER_DEFS = {ATTN: _attn_defs, RWKV: _rwkv_defs}
_FFN_DEFS = {DENSE: _dense_ffn_defs, MOE: _moe_ffn_defs,
             RWKVCM: _rwkvcm_defs}


def _not_ported(cfg: ModelConfig, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: {what} layers are not ported to repro_torch yet "
        "(ported: attention mixers with dense or MoE FFNs, RWKV6)")


def _stack(defs: dict, n: int) -> dict:
    """Prepend the unit-stack dimension to every leaf."""
    return {k: ParamDef((n,) + d.shape, (None,) + tuple(d.spec), d.init,
                        d.dtype)
            for k, d in defs.items()}


def param_defs(cfg: ModelConfig, topo: Topology) -> dict:
    tp = topo.tp
    D = cfg.d_model
    Vp = vocab_padded(cfg, topo)
    unit = cfg.unit()
    n_units = cfg.n_layers // unit
    mixers, ffns = cfg.mixers(), cfg.ffns()
    if cfg.is_encoder_decoder:
        raise _not_ported(cfg, "encoder-decoder")
    if cfg.frontend:
        raise _not_ported(cfg, f"{cfg.frontend!r} frontend")

    units = {}
    for pos in range(unit):
        if mixers[pos] not in _MIXER_DEFS:
            raise _not_ported(cfg, f"{mixers[pos]!r} mixer")
        if ffns[pos] not in _FFN_DEFS:
            raise _not_ported(cfg, f"{ffns[pos]!r} FFN")
        d = dict(_MIXER_DEFS[mixers[pos]](cfg, topo))
        d.update(_FFN_DEFS[ffns[pos]](cfg, topo))
        units[f"p{pos}"] = _stack(d, n_units)

    tree = {
        "embed": ParamDef((Vp, D), (tp, "data"), "embed"),
        "units": units,
        "final_norm": ParamDef((D,), ("data",), "zeros"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((D, Vp), ("data", tp))
    return tree


def _leaves(tree: dict, path: tuple = ()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def param_specs(cfg: ModelConfig, topo: Topology) -> dict:
    out: dict = {}
    for path, d in _leaves(param_defs(cfg, topo)):
        _set(out, path, d.spec)
    return out


# --------------------------------------------------------------------- init
def _init_leaf(d: ParamDef, cfg: ModelConfig, gen: torch.Generator,
               device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "decay":
        # RWKV6 decay base: a linspace over the global last axis
        ramp = torch.linspace(-6.0, -1.0, d.shape[-1], dtype=d.dtype,
                              device=device)
        return ramp.expand(d.shape).clone()
    scale = 0.02
    if d.init == "out_proj":
        scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    elif d.init == "embed":
        scale = 1.0 / math.sqrt(cfg.d_model)
    elif d.init != "normal":
        raise ValueError(f"unknown init {d.init!r}")
    x = torch.randn(d.shape, generator=gen, dtype=d.dtype, device=device)
    return x.mul_(scale)


def init_params(cfg: ModelConfig, topo: Topology, seed: int = 0, *,
                device) -> dict:
    """Random master weights placed on the cube, made on ``device`` from one
    ``torch.Generator`` seeded with ``seed``: leaf by leaf, and a stacked
    leaf unit by unit straight into its cube layout, so the peak beyond the
    weights is one unit's global slice and its placed copy (an MoE model's
    three expert leaves hold most of its bytes). The global
    values depend only on (cfg, seed, padded vocab), not on the cube, so two
    topologies with the same padded vocab hold the same model."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cube = topo.cube
    out: dict = {}
    for path, d in _leaves(param_defs(cfg, topo)):
        if path[0] != "units":
            _set(out, path, cube.to_cube(_init_leaf(d, cfg, gen, device),
                                         d.spec))
            continue
        unit = dataclasses.replace(d, shape=d.shape[1:], spec=d.spec[1:])
        c, placed = cube.ndim, None
        for u in range(d.shape[0]):
            y = cube.place(_init_leaf(unit, cfg, gen, device), unit.spec)
            if placed is None:      # the stack of units, in place's layout
                placed = y.new_empty(y.shape[:c] + (d.shape[0],)
                                     + y.shape[c:])
            placed.select(c, u).copy_(y)
            del y                   # before the next unit is made
        _set(out, path, placed.expand(cube.dim_sizes
                                      + tuple(placed.shape[c:])))
    return out


def from_jax_params(cfg: ModelConfig, topo: Topology, tree, *,
                    device) -> dict:
    """Place the JAX package's global parameter arrays on the port's cube.

    ``tree`` mirrors ``repro.models.params.init_params`` with every leaf as
    a NumPy array (``np.asarray`` of the JAX leaf); each one lands under its
    ``ParamDef.spec``, so both packages compute the same model."""
    out: dict = {}
    for path, d in _leaves(param_defs(cfg, topo)):
        arr = np.asarray(_get(tree, path))
        if tuple(arr.shape) != tuple(d.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"{d.shape} of the port's def")
        glob = torch.tensor(arr, dtype=d.dtype, device=device)
        _set(out, path, topo.cube.to_cube(glob, d.spec))
    return out
