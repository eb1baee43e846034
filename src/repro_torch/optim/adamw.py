"""AdamW with optional 8-bit companded moments.

The counterpart of ``repro.optim.adamw``. Moments are quantized per
last-axis row (absmax int8, sqrt-companded for m, 4th-root for v), the
analogue of the paper's 8-bit cross-domain trick (§V-C): the optimizer
state stays narrow, a quarter of f32 moments' bytes.

Every function works per PE on the trainer's compact master weights
(``repro_torch.models.params.trainable``): a leaf is ``(*cube, *local)``
with size 1 on the dims its spec does not name, and all the math runs over
the last local axis, so each PE quantizes its own shard as the JAX
package's shard_map body does. ``cube_ndim`` says how many leading axes are
the cube's (the weight decay skips leaves whose local block is 1-D, as the
reference's per-shard ``p.ndim > 1`` does). No collectives.
``torch.round`` rounds half to even, as ``jnp.round`` does. ``update``
writes in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import (
    flat_leaves, get_path, leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    use_8bit: bool = True


def _quant_m(x):
    """Signed sqrt-companded int8 (precision concentrated near zero)."""
    amax = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12)
    q = torch.round(127.0 * torch.sign(x) * torch.sqrt(x.abs() / amax))
    return q.to(torch.int8), amax.to(torch.float32)


def _dequant_m(q, amax):
    qf = q.to(torch.float32)
    return torch.sign(qf) * torch.square(qf / 127.0) * amax


def _quant_v(x):
    """Non-negative 4th-root-companded int8: second moments span many
    orders of magnitude; linear absmax would zero small rows and blow up
    1/sqrt(v) updates."""
    amax = torch.clamp_min(x.amax(dim=-1, keepdim=True), 1e-20)
    q = torch.round(127.0 * torch.pow(x / amax, 0.25))
    return q.to(torch.int8), amax.to(torch.float32)


def _dequant_v(q, amax):
    return torch.pow(q.to(torch.float32) / 127.0, 4.0) * amax


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like ``params`` (compact cube leaves) and a step
    counter (0-d int32 on the leaves' device)."""
    def leaf(p):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=p.device)
        if cfg.use_8bit:
            scale = tuple(p.shape[:-1]) + (1,)
            return {"m_q": zeros(p.shape, torch.int8),
                    "m_s": zeros(scale, torch.float32),
                    "v_q": zeros(p.shape, torch.int8),
                    "v_s": zeros(scale, torch.float32)}
        return {"m": zeros(p.shape, torch.float32),
                "v": zeros(p.shape, torch.float32)}
    device = flat_leaves(params)[0].device
    return {"mu": tree_map(leaf, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_defs(param_defs_tree: dict, cfg: AdamWConfig, cube=None) -> dict:
    """(global shape, spec, dtype) tree mirroring ``init_state`` (the
    reference's dry-run structs). A scale array's global last axis has one
    column per shard of the parameter's last axis, under the same spec."""
    def shards(entry) -> int:
        if entry is None or cube is None:
            return 1
        names = (entry,) if isinstance(entry, str) else entry
        return math.prod(cube.size(a) for a in names)

    def leaf(d):
        spec = tuple(d.spec)
        s_shape = tuple(d.shape[:-1]) + (shards(spec[-1] if spec else None),)
        if cfg.use_8bit:
            return {"m_q": (d.shape, spec, torch.int8),
                    "m_s": (s_shape, spec, torch.float32),
                    "v_q": (d.shape, spec, torch.int8),
                    "v_s": (s_shape, spec, torch.float32)}
        return {"m": (d.shape, spec, torch.float32),
                "v": (d.shape, spec, torch.float32)}
    return {"mu": tree_map(leaf, param_defs_tree),
            "step": ((), (), torch.int32)}


# A large leaf is updated in slices of about this many elements along its
# outermost axis longer than 1, so that its f32 temporaries stay a slice's
# and each slice is contiguous: a stacked expert leaf of qwen2-moe-a2.7b at
# 6 layers is 4.15 GB in f32, and the update holds about seven such
# temporaries at once. Every operation of the update is elementwise or a
# maximum over a row of the last axis, so a slice along any other axis
# computes what the whole leaf does: on the card bit for bit; on the CPU a
# vectorized loop may round a slice's tail elements on its scalar path, an
# ulp apart.
SLICE_ELEMS = 1 << 27


def _slices(p):
    """Index tuples covering ``p`` in SLICE_ELEMS-sized runs of its
    outermost axis longer than 1 (the whole leaf when that axis is the
    last one or the leaf is no larger than SLICE_ELEMS)."""
    axis = next((a for a, n in enumerate(p.shape) if n > 1), p.dim() - 1)
    if p.numel() <= SLICE_ELEMS or axis >= p.dim() - 1:
        return [(...,)]
    n = p.shape[axis]
    step = max(1, SLICE_ELEMS // (p.numel() // n))
    head = (slice(None),) * axis
    return [head + (slice(i, i + step),) for i in range(0, n, step)]


def update(params: dict, state: dict, grads: dict, *, lr,
           cfg: AdamWConfig, cube_ndim: int = 0):
    """One AdamW step on per-PE leaves ``(*cube, *local)`` (the first
    ``cube_ndim`` axes are the cube's). ``lr`` is a float or a 0-d f32
    tensor. The parameters and moments are written in place, leaf by leaf
    and a large leaf slice by slice (``SLICE_ELEMS``; the reference
    returns new arrays): a full-width model's f32 masters and moments are
    never held twice. Returns ``(params, state)``, the given tensors and a
    new step counter."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                      device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                      device=t.device), t)

    def leaf(p, mu, g):
        g = g.to(torch.float32)
        if cfg.use_8bit:
            m = _dequant_m(mu["m_q"], mu["m_s"])
            v = _dequant_v(mu["v_q"], mu["v_s"])
        else:
            m, v = mu["m"], mu["v"]
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        decay = cfg.weight_decay if p.dim() - cube_ndim > 1 else 0.0
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (upd + decay * pf))
        if cfg.use_8bit:
            mq, ms = _quant_m(m)
            vq, vs = _quant_v(v)
            new = {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
        else:
            new = {"m": m, "v": v}
        for k, x in new.items():
            mu[k].copy_(x)

    for path, p in leaves(params):
        mu, g = get_path(state["mu"], path), get_path(grads, path)
        for ix in _slices(p):
            leaf(p[ix], {k: t[ix] for k, t in mu.items()}, g[ix])
    return params, {"mu": state["mu"], "step": step}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; ``lr(step)`` is a 0-d f32 tensor on the
    step's device (the step is an int or a 0-d tensor)."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr
