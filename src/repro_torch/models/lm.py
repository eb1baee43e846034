"""The unified model over the in-process PE cube: embedding -> unit stack ->
head, plus the full-sequence logits used by tests and serving checks.

The counterpart of ``repro.models.lm``. Parameters and activations are cube
tensors (``(*cube.dim_sizes, ...)``); the JAX package's ``pscan`` over the
stacked units is a Python loop. The compute dtype is an explicit argument
(default bf16).

Ported: token embedding (vocab-parallel), the trunk of attention layers
with dense or MoE FFNs and of RWKV6 layers (time-mix + channel-mix), and
``forward_logits``. The training loss, the encoder and the patch frontend
wait for later slices.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig, MOE, RWKV, RWKVCM
from repro_torch.models.layers import rms_norm, cube_matmul, pe_slice
from repro_torch.models.params import param_specs
from repro_torch.models.topology import Topology


class Model:
    def __init__(self, cfg: ModelConfig, topo: Topology, *,
                 dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.topo = topo
        self.dtype = dtype
        self.specs = param_specs(cfg, topo)
        self.unit = cfg.unit()
        self.n_units = cfg.n_layers // self.unit
        self.mixers = cfg.mixers()[: self.unit]
        self.ffns = cfg.ffns()[: self.unit]
        # per-layer windows as plain ints (the loop needs no traced form)
        self.windows = cfg.windows().reshape(self.n_units, self.unit)
        # per-position specs without the unit-stack dim (for FSDP gather)
        self.unit_specs = {
            pos: {k: tuple(s)[1:] for k, s in self.specs["units"][pos].items()}
            for pos in self.specs["units"]}

    def unit_params(self, params, u: int, p: int) -> dict:
        """Unit ``u``'s stacked leaves at position ``p`` (cube views)."""
        cn = self.topo.cube.ndim
        return {k: v.select(cn, u)
                for k, v in params["units"][f"p{p}"].items()}

    # ------------------------------------------------------------ embedding
    def _gather_embed(self, params):
        emb = params["embed"].to(self.dtype)
        spec = tuple(self.specs["embed"])
        if "data" in spec:
            emb = self.topo.comm(("data",)).all_gather(
                emb, axis=spec.index("data"))
        return emb

    def _embed_tokens(self, emb_l, tokens):
        """Vocab-parallel lookup -> partial (*cube, B, S, D) (needs a sum
        over tp). emb_l: (*cube, Vl, D); tokens: (*cube, B, S)."""
        cn = self.topo.cube.ndim
        Vl, D = emb_l.shape[cn], emb_l.shape[cn + 1]
        me = self.topo.axis_index(self.topo.tp, tokens.device)
        ids = tokens - (me * Vl).reshape(me.shape + (1,) * (tokens.dim() - cn))
        valid = (ids >= 0) & (ids < Vl)
        n = math.prod(emb_l.shape[:cn])
        flat = ids.clamp(0, Vl - 1).reshape(n, -1)
        x = torch.gather(emb_l.reshape(n, Vl, D), 1,
                         flat[..., None].expand(flat.shape + (D,)))
        x = x.reshape(tuple(tokens.shape) + (D,))
        return torch.where(valid[..., None], x, torch.zeros_like(x))

    def _to_sp(self, x_partial):
        """Partial-over-tp full-seq (*cube, B, S, D) -> sequence-sharded
        (*cube, B, S_sp, D)."""
        topo = self.topo
        if topo.cp:
            S_cp = x_partial.shape[topo.cube.ndim + 1] // topo.size(topo.cp)
            me = topo.axis_index(topo.cp, x_partial.device)
            x_partial = pe_slice(x_partial, me * S_cp, S_cp, 1,
                                 topo.cube.ndim)
        return topo.comm(topo.tp).reduce_scatter(x_partial, axis=1)

    def embed_input(self, params, batch):
        """-> x_sp (*cube, B, S_sp, D). batch["tokens"]: (*cube, B, S)."""
        if self.cfg.frontend:
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.frontend!r} frontend is not "
                "ported to repro_torch yet")
        emb_l = self._gather_embed(params)
        return self._to_sp(self._embed_tokens(emb_l, batch["tokens"]))

    # ------------------------------------------------------------ the trunk
    def _position_fn(self, x_sp, w_shards, window: int, *, p: int):
        """One layer (mixer + ffn) at unit position ``p``."""
        cfg, topo = self.cfg, self.topo
        w = blocks.gather_params(w_shards, self.unit_specs[f"p{p}"], topo,
                                 self.dtype)
        # param_defs raised at construction for unported layer kinds
        mixer, ffn = self.mixers[p], self.ffns[p]
        if mixer == RWKV:
            x_sp = blocks.rwkv_mix(cfg, topo, w, x_sp)
        else:
            x_sp = blocks.attn_block(cfg, topo, w, x_sp, window=window)
        if ffn == MOE:
            # the aux load-balance loss feeds only the training loss
            return blocks.moe_ffn(cfg, topo, w, x_sp)[0]
        if ffn == RWKVCM:
            return blocks.rwkv_channel_mix(cfg, topo, w, x_sp)
        return blocks.dense_ffn(cfg, topo, w, x_sp)

    def trunk(self, params, x_sp):
        """The unit stack, as a loop over units and positions."""
        for u in range(self.n_units):
            for p in range(self.unit):
                x_sp = self._position_fn(
                    x_sp, self.unit_params(params, u, p),
                    int(self.windows[u, p]), p=p)
        return x_sp

    # ------------------------------------------------------------- the head
    def final_norm(self, params):
        return blocks.gather_params(
            {"n": params["final_norm"]}, {"n": self.specs["final_norm"]},
            self.topo, self.dtype)["n"]

    def _head(self, params):
        if self.cfg.tie_embeddings:
            return self._gather_embed(params).transpose(-2, -1)  # (.., D, Vl)
        return blocks.gather_params(
            {"h": params["lm_head"]}, {"h": self.specs["lm_head"]},
            self.topo, self.dtype)["h"]

    def forward_logits(self, params, batch):
        """Full-sequence logits (*cube, B, S, Vl), f32."""
        topo = self.topo
        x_sp = self.embed_input(params, batch)
        x_sp = self.trunk(params, x_sp)
        full = topo.comm(topo.sp).all_gather(x_sp, axis=1)
        hn = rms_norm(full, self.final_norm(params), self.cfg.norm_eps)
        return cube_matmul(hn, self._head(params), topo.cube.ndim).float()
