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

Every def of the reference: attention (self and, under the prefix
``"x"``, the encoder-decoder's cross-attention), Mamba, RWKV6 time-mix and
channel-mix, dense FFN and MoE FFN, the encoder stack of an
encoder-decoder model and the frontends' projection (patch and audio).

Resident serve weights (``resident=True``) take the specs with the
``data`` axis dropped (``drop_axis``): each leaf is placed whole on every
data PE, a stride-0 view over ``data`` of one compact block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.models.config import (
    ModelConfig, ATTN, DENSE, MAMBA, MOE, RWKV, RWKVCM)
from repro_torch.models.topology import Topology

MASTER_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    spec: tuple
    init: str = "normal"       # normal | zeros | ones | out_proj | embed
                               # | decay | a_log | dt
    dtype: Any = MASTER_DTYPE
    sum_axes: str = ""         # "" | "tp" | "ep" -- grad psum group


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def kv_is_sharded(cfg: ModelConfig, topo: Topology) -> bool:
    t = topo.tp_size
    return cfg.n_kv_heads >= t and cfg.n_kv_heads % t == 0


def vocab_padded(cfg: ModelConfig, topo: Topology) -> int:
    return _round_up(cfg.vocab_size, topo.tp_size)


def dt_rank(cfg: ModelConfig) -> int:
    """Mamba's low-rank dt projection width."""
    return _round_up(cfg.d_model // 16, 8)


# --------------------------------------------------------------------- defs
def _attn_defs(cfg, topo, prefix=""):
    """Attention leaves; ``prefix`` "x" names the cross-attention's (which
    has no qk norm)."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tp = topo.tp
    kv_spec = ("data", tp) if kv_is_sharded(cfg, topo) else ("data", None)
    kv_sum = "" if kv_is_sharded(cfg, topo) else "tp"
    d = {
        prefix + "ln": ParamDef((D,), ("data",), "zeros", sum_axes="tp"),
        prefix + "wq": ParamDef((D, H * hd), ("data", tp)),
        prefix + "wkv": ParamDef((D, 2 * KV * hd), kv_spec, sum_axes=kv_sum),
        prefix + "wo": ParamDef((H * hd, D), (tp, "data"), "out_proj"),
    }
    if cfg.qk_norm and not prefix:
        d["q_norm"] = ParamDef((hd,), (None,), "zeros", sum_axes="tp")
        d["k_norm"] = ParamDef((hd,), (None,), "zeros", sum_axes="tp")
    return d


def _mamba_defs(cfg, topo):
    """Mamba leaves. ``in_proj``'s columns are laid out (din, 2): each
    channel's (x, z) pair stays adjacent, so sharding the columns over tp
    slices whole channels."""
    D = cfg.d_model
    din = cfg.mamba_expand * D
    n = cfg.d_state
    R = dt_rank(cfg)
    tp = topo.tp
    return {
        "ln": ParamDef((D,), ("data",), "zeros", sum_axes="tp"),
        "in_proj": ParamDef((D, 2 * din), ("data", tp)),
        "conv_w": ParamDef((cfg.conv_kernel, din), (None, tp)),
        "conv_b": ParamDef((din,), (tp,), "zeros"),
        "x_proj": ParamDef((din, R + 2 * n), (tp, None)),
        "dt_proj": ParamDef((R, din), (None, tp)),
        "dt_bias": ParamDef((din,), (tp,), "dt"),
        "a_log": ParamDef((din, n), (tp, None), "a_log"),
        "d_skip": ParamDef((din,), (tp,), "ones"),
        "out_proj": ParamDef((din, D), (tp, "data"), "out_proj"),
    }


def _dense_ffn_defs(cfg, topo):
    D, F = cfg.d_model, cfg.d_ff
    tp = topo.tp
    return {
        "fln": ParamDef((D,), ("data",), "zeros", sum_axes="tp"),
        "wg": ParamDef((D, F), ("data", tp)),
        "wu": ParamDef((D, F), ("data", tp)),
        "wd": ParamDef((F, D), (tp, "data"), "out_proj"),
    }


def _moe_ffn_defs(cfg, topo):
    D, Fe = cfg.d_model, cfg.d_ff_expert
    Ep = cfg.n_experts_padded
    ep, etp = topo.ep, topo.etp
    d = {
        "fln": ParamDef((D,), ("data",), "zeros", sum_axes="ep"),
        "router": ParamDef((D, Ep), ("data", None), sum_axes="ep"),
        "we_g": ParamDef((Ep, D, Fe), (ep, "data", etp)),
        "we_u": ParamDef((Ep, D, Fe), (ep, "data", etp)),
        "we_d": ParamDef((Ep, Fe, D), (ep, etp, "data"), "out_proj"),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        d["ws_g"] = ParamDef((D, Fs), ("data", None), sum_axes="ep")
        d["ws_u"] = ParamDef((D, Fs), ("data", None), sum_axes="ep")
        d["ws_d"] = ParamDef((Fs, D), (None, "data"), "out_proj",
                             sum_axes="ep")
    return d


def _rwkv_defs(cfg, topo):
    D = cfg.d_model
    tp = topo.tp
    lora = 64
    return {
        "ln": ParamDef((D,), ("data",), "zeros", sum_axes="tp"),
        "mu": ParamDef((5, D), (None, "data"), sum_axes="tp"),
        "wr": ParamDef((D, D), ("data", tp)),
        "wk": ParamDef((D, D), ("data", tp)),
        "wv": ParamDef((D, D), ("data", tp)),
        "wg": ParamDef((D, D), ("data", tp)),
        "w_lora_a": ParamDef((D, lora), ("data", None), sum_axes="tp"),
        "w_lora_b": ParamDef((lora, D), (None, tp)),
        "decay_w0": ParamDef((D,), (tp,), "decay"),
        "bonus_u": ParamDef((D,), (tp,)),
        "wo": ParamDef((D, D), (tp, "data"), "out_proj"),
    }


def _rwkvcm_defs(cfg, topo):
    D, F = cfg.d_model, cfg.d_ff
    tp = topo.tp
    return {
        "fln": ParamDef((D,), ("data",), "zeros", sum_axes="tp"),
        "cm_mu": ParamDef((2, D), (None, "data"), sum_axes="tp"),
        "cm_r": ParamDef((D, D), ("data", None), sum_axes="tp"),
        "cm_k": ParamDef((D, F), ("data", tp)),
        "cm_v": ParamDef((F, D), (tp, "data"), "out_proj"),
    }


_MIXER_DEFS = {ATTN: _attn_defs, MAMBA: _mamba_defs, RWKV: _rwkv_defs}
_FFN_DEFS = {DENSE: _dense_ffn_defs, MOE: _moe_ffn_defs,
             RWKVCM: _rwkvcm_defs}


def _stack(defs: dict, n: int) -> dict:
    """Prepend the unit-stack dimension to every leaf."""
    return {k: dataclasses.replace(d, shape=(n,) + d.shape,
                                   spec=(None,) + tuple(d.spec))
            for k, d in defs.items()}


def param_defs(cfg: ModelConfig, topo: Topology) -> dict:
    tp = topo.tp
    D = cfg.d_model
    Vp = vocab_padded(cfg, topo)
    unit = cfg.unit()
    n_units = cfg.n_layers // unit
    mixers, ffns = cfg.mixers(), cfg.ffns()

    units = {}
    for pos in range(unit):
        d = dict(_MIXER_DEFS[mixers[pos]](cfg, topo))
        d.update(_FFN_DEFS[ffns[pos]](cfg, topo))
        if cfg.is_encoder_decoder and mixers[pos] == ATTN:
            d.update(_attn_defs(cfg, topo, prefix="x"))   # cross-attention
        units[f"p{pos}"] = _stack(d, n_units)

    tree = {
        "embed": ParamDef((Vp, D), (tp, "data"), "embed"),
        "units": units,
        "final_norm": ParamDef((D,), ("data",), "zeros", sum_axes="tp"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((D, Vp), ("data", tp))
    if cfg.frontend:
        tree["frontend_proj"] = ParamDef((cfg.frontend_dim or D, D),
                                         (None, "data"), sum_axes="tp")
    if cfg.is_encoder_decoder:
        # the encoder: uniform attention + dense FFN layers
        d = dict(_attn_defs(cfg, topo))
        d.update(_dense_ffn_defs(cfg, topo))
        tree["enc_units"] = {"p0": _stack(d, cfg.n_enc_layers)}
        tree["enc_final_norm"] = ParamDef((D,), ("data",), "zeros",
                                          sum_axes="tp")
    return tree


def _resident_defs(defs: dict) -> dict:
    """``defs`` with every spec's ``data`` axis dropped (resident serve
    weights)."""
    specs = drop_axis(tree_map(lambda d: d.spec, defs))
    return tree_map(lambda d, s: dataclasses.replace(d, spec=s), defs, specs)


def leaves(tree: dict, path: tuple = ()):
    """(path, leaf) pairs of a nested dict, keys in sorted order (the order
    of ``jax.tree.flatten`` on the JAX package's dicts)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def set_path(tree: dict, path: tuple, value) -> None:
    """Put ``value`` at ``path`` of nested dicts, making the dicts on the
    way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def get_path(tree, path: tuple):
    """The subtree or leaf of nested dicts at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def param_specs(cfg: ModelConfig, topo: Topology, *,
                resident: bool = False) -> dict:
    """Each leaf's spec; ``resident`` drops the ``data`` axis from them
    (``drop_axis``)."""
    out: dict = {}
    for path, d in leaves(param_defs(cfg, topo)):
        set_path(out, path, d.spec)
    return drop_axis(out) if resident else out


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
    if d.init == "a_log":
        # Mamba's S4D-real A: log(1 .. N) along the state axis
        a = torch.arange(1, d.shape[-1] + 1, dtype=d.dtype, device=device)
        return torch.log(a).expand(d.shape).clone()
    if d.init == "dt":
        # Mamba's dt bias: the inverse softplus of dt, log-uniform in
        # [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(d.shape, generator=gen, dtype=d.dtype, device=device)
        dt = torch.exp(lo + u * (hi - lo))
        return dt + torch.log(-torch.expm1(-dt))
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
                device, resident: bool = False) -> dict:
    """Random master weights placed on the cube, made on ``device`` from one
    ``torch.Generator`` seeded with ``seed``: leaf by leaf, and a stacked
    leaf unit by unit straight into its cube layout, so the peak beyond the
    weights is one unit's global slice and its placed copy (an MoE model's
    three expert leaves hold most of its bytes). The global
    values depend only on (cfg, seed, padded vocab), not on the cube, so two
    topologies with the same padded vocab hold the same model.
    ``resident`` places them under the resident specs (the same values,
    one compact block a leaf over ``data``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cube = topo.cube
    defs = param_defs(cfg, topo)
    if resident:
        defs = _resident_defs(defs)
    out: dict = {}
    for path, d in leaves(defs):
        if path[0] != "units":
            set_path(out, path, cube.to_cube(_init_leaf(d, cfg, gen, device),
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
        set_path(out, path, placed.expand(cube.dim_sizes
                                      + tuple(placed.shape[c:])))
    return out


def from_jax_params(cfg: ModelConfig, topo: Topology, tree, *,
                    device, resident: bool = False) -> dict:
    """Place the JAX package's global parameter arrays on the port's cube.

    ``tree`` mirrors ``repro.models.params.init_params`` with every leaf as
    a NumPy array (``np.asarray`` of the JAX leaf); each one lands under its
    ``ParamDef.spec`` (the resident spec with ``resident``), so both
    packages compute the same model."""
    defs = param_defs(cfg, topo)
    if resident:
        defs = _resident_defs(defs)
    out: dict = {}
    for path, d in leaves(defs):
        arr = np.asarray(get_path(tree, path))
        if tuple(arr.shape) != tuple(d.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"{d.shape} of the port's def")
        glob = torch.tensor(arr, dtype=d.dtype, device=device)
        set_path(out, path, topo.cube.to_cube(glob, d.spec))
    return out


# ------------------------------------------------------------ spec trees
def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of nested dicts of one structure (the port's
    ``jax.tree.map``); leaves in ``leaves`` order."""
    out: dict = {}
    for path, leaf in leaves(tree):
        set_path(out, path, fn(leaf, *(get_path(r, path) for r in rest)))
    return out


def flat_leaves(tree: dict) -> list:
    """The leaves of nested dicts in ``leaves`` order, so flat indices
    agree with the JAX package's."""
    return [leaf for _, leaf in leaves(tree)]


def unflatten(tree: dict, leaves) -> dict:
    """Nested dicts of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def drop_axis(spec_tree: dict, axis: str = "data") -> dict:
    """Replace ``axis`` with None in every spec of a tree (the reference's
    serve-time resident weights: parameters replicated over the data axis
    so decode never re-gathers them)."""
    def fix(spec):
        out = []
        for e in tuple(spec):
            if e == axis:
                out.append(None)
            elif isinstance(e, tuple):
                kept = tuple(a for a in e if a != axis)
                out.append(kept if kept else None)
            else:
                out.append(e)
        return tuple(out)
    return tree_map(fix, spec_tree)


def grad_sum_spec(cfg: ModelConfig, topo: Topology) -> dict:
    """Per-leaf tuple of logical axes over which gradients are summed (the
    ``sum_axes`` tags). The trainer derives its reductions from the specs
    (``runtime.trainer.replication_dims``); this is the manual rule, kept
    as executable documentation and for audits, as in the reference."""
    def axes(d: ParamDef):
        if d.sum_axes == "tp":
            return topo.tp
        if d.sum_axes == "ep":
            return topo.ep if topo.ep else topo.tp
        return ()
    return tree_map(axes, param_defs(cfg, topo))


def _spec_dims(spec) -> set:
    names = set()
    for e in tuple(spec):
        if e is not None:
            names.update((e,) if isinstance(e, str) else e)
    return names


def compact(x: torch.Tensor, spec, cube) -> torch.Tensor:
    """``x`` (*cube, *local) with index 0 kept on every cube dim ``spec``
    does not name (size 1 there): ``Hypercube.place``'s layout. A view
    where ``x`` is a broadcast of such a tensor."""
    named = _spec_dims(spec)
    for a, d in enumerate(cube.dim_names):
        if d not in named:
            x = x.narrow(a, 0, 1)
    return x


def trainable(params: dict, specs: dict, cube) -> dict:
    """The compact master weights of cube-layout ``params``: each leaf as
    ``Hypercube.place`` lays it out (size 1 on the dims its spec does not
    name), each replicated block held once. The trainer updates these and
    hands the model per-step view leaves over the full cube
    (``runtime.trainer.view_leaves``), whose per-PE gradients the grad-sync
    program sums over the replicated dims."""
    return tree_map(lambda x, s: compact(x, s, cube).contiguous(), params,
                    specs)


def to_global(tree: dict, specs: dict, cube) -> dict:
    """Every leaf's global tensor (``Hypercube.from_cube``; replicated dims
    read index 0). For tests and checks."""
    return tree_map(lambda x, s: cube.from_cube(x, s), tree, specs)


def from_jax_opt_state(cfg: ModelConfig, topo: Topology, state, *,
                       device) -> dict:
    """Place the JAX package's AdamW state (``repro.optim.adamw.init_state``
    or a state after ``update``, every leaf a NumPy array) on the port's
    cube as compact per-PE tensors, as ``from_jax_params`` places weights.
    A moment takes its parameter's spec; a scale array (global last axis =
    the number of shards of the parameter's last axis) takes it too, so
    each PE holds its own row scales ``(..., 1)``."""
    cube = topo.cube
    defs = param_defs(cfg, topo)
    mu: dict = {}
    for path, d in leaves(defs):
        leaf = get_path(state["mu"], path)
        out = {}
        for name in sorted(leaf):
            arr = np.asarray(leaf[name])
            dtype = torch.int8 if arr.dtype == np.int8 else torch.float32
            glob = torch.tensor(arr, dtype=dtype, device=device)
            out[name] = cube.place(glob, d.spec)
        set_path(mu, path, out)
    return {"mu": mu, "step": torch.tensor(int(np.asarray(state["step"])),
                                           dtype=torch.int32, device=device)}
