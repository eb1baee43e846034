"""The unified model over the in-process PE cube: embedding -> unit stack ->
head, plus the full-sequence logits used by tests and serving checks.

The counterpart of ``repro.models.lm``. Parameters and activations are cube
tensors (``(*cube.dim_sizes, ...)``); the JAX package's ``pscan`` over the
stacked units is a Python loop. The compute dtype is an explicit argument
(default bf16).

Every path of the reference: token embedding (vocab-parallel) with the
patch frontend's projected patches in the first ``frontend_tokens``
positions, the trunk of attention, Mamba and RWKV6 mixers with dense, MoE
or channel-mix FFNs (the hybrid family's layer plan included), with the
per-position remat of the training path, the encoder-decoder's encoder
(``encode``: the audio frontend's projected frames through non-causal
attention layers) and the decoder's cross-attention, the training loss
(``loss_shard``, patch positions masked) and ``forward_logits``; resident
serve weights (``resident=True``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.config import (
    ModelConfig, FULL_WINDOW, MAMBA, MOE, RWKV, RWKVCM)
from repro_torch.models.layers import rms_norm, cube_matmul, pe_slice
from repro_torch.models.params import param_specs
from repro_torch.models.topology import Topology

AUX_COEF = 0.01
CE_CHUNK = 512


class Model:
    def __init__(self, cfg: ModelConfig, topo: Topology, *,
                 dtype: torch.dtype = torch.bfloat16,
                 resident: bool = False):
        """``resident``: serve-time weights replicated over the data axis
        (``params.drop_axis``): place them with ``init_params(...,
        resident=True)``, and no layer gathers them over ``data``."""
        self.cfg = cfg
        self.topo = topo
        self.dtype = dtype
        self.specs = param_specs(cfg, topo, resident=resident)
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
        if cfg.is_encoder_decoder:
            self.enc_specs = {k: tuple(s)[1:] for k, s
                              in self.specs["enc_units"]["p0"].items()}

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
        # one table of every PE's shard: the embedding backward sums
        # repeated ids in a fixed order on CUDA (sorted segments), where
        # torch.gather's backward sums them with atomics in any order
        rows = flat + torch.arange(n, device=flat.device)[:, None] * Vl
        x = F.embedding(rows, emb_l.reshape(n * Vl, D))
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

    def _slice_sp(self, x_full):
        """Replicated full-seq (*cube, B, S, D) -> my sp chunk (no
        reduction)."""
        topo = self.topo
        S_sp = x_full.shape[topo.cube.ndim + 1] // topo.size(topo.sp)
        me = topo.axis_index(topo.sp, x_full.device)
        return pe_slice(x_full, me * S_sp, S_sp, 1, topo.cube.ndim)

    def embed_input(self, params, batch):
        """-> x_sp (*cube, B, S_sp, D) for the decoder / self stack.
        batch["tokens"]: (*cube, B, S). The patch frontend's
        batch["patches"] (*cube, B, F, frontend_dim), replicated over the
        model axes, are projected by ``frontend_proj`` and take the place of
        the first F positions' embeddings: the projection runs on tp rank 0
        alone (the other ranks' partials hold zeros there), so the
        reduce-scatter into the sequence shards adds it once. The audio
        frontend's frames feed the encoder (``encode``), not this
        embedding."""
        x = self._embed_tokens(self._gather_embed(params), batch["tokens"])
        if self.cfg.frontend == "patch":
            x = self._with_patches(params, x, batch["patches"])
        return self._to_sp(x)

    def _with_patches(self, params, x, patches):
        """The partial embeddings ``x`` (*cube, B, S, D) with their first
        F positions replaced by ``patches @ frontend_proj`` on the PEs of
        tp rank 0 and by zeros on the others."""
        topo = self.topo
        cube, cn = topo.cube, topo.cube.ndim
        F_, S = patches.shape[cn + 1], x.shape[cn + 1]
        if F_ > S:
            raise ValueError(f"{self.cfg.name}: {F_} patches do not fit a "
                             f"sequence of {S} positions")
        rank0 = [a for a, d in enumerate(cube.dim_names) if d in topo.tp]

        def tp_rank0(t):
            for a in rank0:
                t = t.narrow(a, 0, 1)
            return t

        wf = self._gathered(params, "frontend_proj")
        part = cube_matmul(tp_rank0(patches).to(self.dtype), tp_rank0(wf),
                           cn).to(x.dtype)                  # (.., B, F, D)
        for a in rank0:             # zeros at tp ranks 1 .. n - 1
            n = cube.dim_sizes[a]
            if n > 1:
                pad = list(part.shape)
                pad[a] = n - 1
                part = torch.cat((part, part.new_zeros(pad)), dim=a)
        return torch.cat((part, x.narrow(cn + 1, F_, S - F_)), dim=cn + 1)

    def _gathered(self, params, name: str):
        return blocks.gather_params({"w": params[name]},
                                    {"w": self.specs[name]}, self.topo,
                                    self.dtype)["w"]

    def _enc_layer(self, x_sp, w_shards):
        w = blocks.gather_params(w_shards, self.enc_specs, self.topo,
                                 self.dtype)
        x_sp = blocks.attn_block(self.cfg, self.topo, w, x_sp,
                                 window=FULL_WINDOW, causal=False)
        return blocks.dense_ffn(self.cfg, self.topo, w, x_sp)

    def encode(self, params, frames, *, remat: bool = False):
        """The encoder of an encoder-decoder model. frames: (*cube, B,
        S_enc, frontend_dim), replicated over the model axes. Returns the
        encoder output, full sequence (*cube, B, S_enc, D): the frames
        projected by ``frontend_proj``, sliced over sp, through the
        non-causal attention + dense FFN layers (each under a checkpoint
        with ``remat``, as the reference's scan body), gathered over sp and
        normed by ``enc_final_norm``."""
        topo = self.topo
        cn = topo.cube.ndim
        x = cube_matmul(frames.to(self.dtype),
                        self._gathered(params, "frontend_proj"), cn)
        x_sp = self._slice_sp(x)
        for w in self.unit_slices(params["enc_units"]["p0"]):
            if remat:
                x_sp = checkpoint(self._enc_layer, x_sp, w,
                                  use_reentrant=False)
            else:
                x_sp = self._enc_layer(x_sp, w)
        full = topo.comm(topo.sp).all_gather(x_sp, axis=1)
        return rms_norm(full, self._gathered(params, "enc_final_norm"),
                        self.cfg.norm_eps)

    def unit_slices(self, stacked: dict) -> list:
        """The per-unit leaves of stacked ``{name: (*cube, n, ...)}``, one
        dict a unit: the leaves are unbound once, so each one's gradient
        is one stack of the per-unit gradients."""
        cn = self.topo.cube.ndim
        parts = {k: v.unbind(cn) for k, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[u] for k, v in parts.items()} for u in range(n)]

    # ------------------------------------------------------------ the trunk
    def _position_fn(self, x_sp, w_shards, enc_out=None, *, window: int,
                     p: int):
        """One layer (mixer + ffn) at unit position ``p``, from sharded
        params; an encoder-decoder's attention layer attends to
        ``enc_out`` after itself (cross-attention). Returns (x_sp, aux):
        aux is the MoE load-balance loss per PE (*cube), zero for the other
        FFNs."""
        cfg, topo = self.cfg, self.topo
        w = blocks.gather_params(w_shards, self.unit_specs[f"p{p}"], topo,
                                 self.dtype)
        mixer, ffn = self.mixers[p], self.ffns[p]
        if mixer == RWKV:
            x_sp = blocks.rwkv_mix(cfg, topo, w, x_sp)
        elif mixer == MAMBA:
            x_sp = blocks.mamba_mix(cfg, topo, w, x_sp)
        else:
            x_sp = blocks.attn_block(cfg, topo, w, x_sp, window=window)
            if enc_out is not None:
                x_sp = blocks.attn_block(cfg, topo, w, x_sp,
                                         window=FULL_WINDOW,
                                         cross_src=enc_out, prefix="x")
        if ffn == MOE:
            x_sp, aux = blocks.moe_ffn(cfg, topo, w, x_sp)
            return x_sp, aux.float()
        if ffn == RWKVCM:
            x_sp = blocks.rwkv_channel_mix(cfg, topo, w, x_sp)
        else:
            x_sp = blocks.dense_ffn(cfg, topo, w, x_sp)
        return x_sp, x_sp.new_zeros(topo.cube.dim_sizes, dtype=torch.float32)

    def trunk(self, params, x_sp, *, enc_out=None, remat: bool = False):
        """The unit stack, as a loop over units and positions. Returns
        (x_sp, aux) with aux the summed MoE load-balance loss (*cube).
        ``remat`` runs each position under ``torch.utils.checkpoint``
        (non-reentrant), as the reference's ``_unit_fn`` runs each under
        ``jax.checkpoint``: the backward keeps one layer's gathered weights
        and activations, recomputing the position's forward. The stacked
        leaves are unbound once, so each leaf's gradient is one stack of
        the per-unit gradients."""
        stacked = {pos: self.unit_slices(ws)
                   for pos, ws in params["units"].items()}
        aux = x_sp.new_zeros(self.topo.cube.dim_sizes, dtype=torch.float32)
        for u in range(self.n_units):
            for p in range(self.unit):
                w = stacked[f"p{p}"][u]
                fn = functools.partial(self._position_fn,
                                       window=int(self.windows[u, p]), p=p)
                if remat:
                    x_sp, a = checkpoint(fn, x_sp, w, enc_out,
                                         use_reentrant=False)
                else:
                    x_sp, a = fn(x_sp, w, enc_out)
                aux = aux + a
        return x_sp, aux

    # ------------------------------------------------------------- the head
    def final_norm(self, params):
        return self._gathered(params, "final_norm")

    def _head(self, params):
        if self.cfg.tie_embeddings:
            return self._gather_embed(params).transpose(-2, -1)  # (.., D, Vl)
        return self._gathered(params, "lm_head")

    def _encoded(self, params, batch, *, remat: bool = False):
        """The encoder's output for ``batch["frames"]`` (None for a
        decoder-only model)."""
        if not self.cfg.is_encoder_decoder:
            return None
        return self.encode(params, batch["frames"], remat=remat)

    # ------------------------------------------------------------- the loss
    def loss_shard(self, params, batch):
        """The training loss on the cube: vocab-parallel cross-entropy over
        ``CE_CHUNK``-token chunks, each chunk's logits recomputed in the
        backward (a checkpoint), as ``repro.models.lm.Model.loss_shard``.
        batch["tokens"], batch["labels"]: (*cube, B_l, S); labels < 0 are
        masked out, and so are the patch frontend's first
        ``frontend_tokens`` positions. Returns ``(loss, metrics)``, each a (*cube) tensor
        holding the same value on every PE: ``loss + AUX_COEF * aux`` and
        {"ce_loss", "aux_loss", "tokens"}.

        The cube's all-reduces are sums over its axes, so autograd through
        them is exact; the reference's ``replicated_psum`` (whose identity
        backward undoes the transpose's x G under shard_map) has no
        counterpart here. The max all-reduce runs on detached logits, as
        the reference stops its gradient. A backward seeded from every
        PE's copy of the loss would count it once per PE: the trainer
        seeds from their mean."""
        cfg, topo = self.cfg, self.topo
        if topo.cp:
            raise ValueError("context parallelism is an inference-only path")
        cn = topo.cube.ndim
        enc_out = self._encoded(params, batch, remat=True)
        x_sp = self.embed_input(params, batch)
        x_sp, aux = self.trunk(params, x_sp, enc_out=enc_out, remat=True)
        full = topo.comm(topo.sp).all_gather(x_sp, axis=1)
        hn = rms_norm(full, self.final_norm(params), cfg.norm_eps)
        head = self._head(params)
        labels = batch["labels"]
        if cfg.frontend == "patch":
            pos = torch.arange(labels.shape[-1], device=labels.device)
            labels = torch.where(pos < cfg.frontend_tokens,
                                 torch.full_like(labels, -1), labels)
        tpc = topo.comm(topo.tp)
        Vl = head.shape[-1]
        lo = topo.axis_index(topo.tp, labels.device) * Vl
        lo = lo.reshape(lo.shape + (1, 1))
        S = hn.shape[cn + 1]
        nck = max(S // min(CE_CHUNK, S), 1)
        Ck = S // nck

        def ce(hc, head, lc):
            logits = cube_matmul(hc, head, cn).float()     # (.., B, Ck, Vl)
            m = tpc.all_reduce(logits.detach().amax(dim=-1), op="max")
            se = tpc.all_reduce(torch.exp(logits - m[..., None]).sum(-1))
            lse = torch.log(se) + m
            ids = lc - lo
            ok = (ids >= 0) & (ids < Vl)
            tl = torch.gather(logits, -1,
                              ids.clamp(0, Vl - 1)[..., None])[..., 0]
            tl = tpc.all_reduce(torch.where(ok, tl, torch.zeros_like(tl)))
            msk = (lc >= 0).float()
            return (((lse - tl) * msk).sum(dim=(-2, -1)),
                    msk.sum(dim=(-2, -1)))

        tot = cnt = x_sp.new_zeros(topo.cube.dim_sizes, dtype=torch.float32)
        for i in range(nck):
            hc = hn.narrow(cn + 1, i * Ck, Ck)
            lc = labels.narrow(cn + 1, i * Ck, Ck)
            t, c = checkpoint(ce, hc, head, lc, use_reentrant=False)
            tot, cnt = tot + t, cnt + c
        dpc = topo.comm(topo.dp)
        tot, cnt = dpc.all_reduce(tot), dpc.all_reduce(cnt)
        loss = tot / torch.clamp_min(cnt, 1.0)
        aux_all = topo.comm(topo.dp + topo.tp).all_reduce(aux) / (
            topo.size(topo.dp) * topo.tp_size)
        metrics = {"ce_loss": loss, "aux_loss": aux_all, "tokens": cnt}
        return loss + AUX_COEF * aux_all, metrics

    def forward_logits(self, params, batch):
        """Full-sequence logits (*cube, B, S, Vl), f32."""
        topo = self.topo
        enc_out = self._encoded(params, batch)
        x_sp = self.embed_input(params, batch)
        x_sp, _ = self.trunk(params, x_sp, enc_out=enc_out)
        full = topo.comm(topo.sp).all_gather(x_sp, axis=1)
        hn = rms_norm(full, self.final_norm(params), self.cfg.norm_eps)
        return cube_matmul(hn, self._head(params), topo.cube.ndim).float()
