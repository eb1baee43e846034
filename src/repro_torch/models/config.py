"""Unified model configuration for the 10 assigned architectures.

A copy of ``repro.models.config`` (the port imports nothing of the JAX
package). One ``ModelConfig`` drives every family (dense / MoE / VLM / audio /
SSM / hybrid). Layers are described by a ``layer_plan``: a per-layer (mixer,
ffn) spec plus a per-layer attention-window array. Layers are grouped into
the smallest repeating *unit* with identical parameter structure; parameters
are stacked per unit and the model loops over the stack.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

# mixer kinds
ATTN = "attn"
MAMBA = "mamba"
RWKV = "rwkv"
# ffn kinds
DENSE = "dense"
MOE = "moe"
RWKVCM = "rwkvcm"   # RWKV channel-mix (receptance-gated 2-matrix FFN)
NONE = "none"

FULL_WINDOW = -1  # sentinel: full (global) attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention details
    rope_theta: float = 1e4
    qk_norm: bool = False
    window: int = FULL_WINDOW                  # default per-layer window
    local_global_ratio: int = 0                # gemma3: N local per 1 global
    local_window: int = 1024

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_period: int = 1            # MoE every `period` layers (jamba: 2)
    capacity_factor: float = 1.25
    moe_dispatch: str = "scatter"  # "scatter" (baseline) | "sort" (PR-style)

    # SSM / hybrid
    mixer_pattern: str = ""        # e.g. "mmmmAmmm" repeated; "" -> all attn
    d_state: int = 16
    mamba_expand: int = 2
    conv_kernel: int = 4
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # multimodal stub frontends
    frontend: str = ""             # "" | "patch" | "audio"
    frontend_tokens: int = 1024    # patches prepended (vlm)
    frontend_dim: int = 0          # raw embedding dim fed by input_specs

    # norms / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ---- parallelism (single-pod model-axis decomposition; data fills rest)
    tp: int = 16                   # attention/FFN tensor-parallel degree
    ep: int = 1                    # expert-parallel degree (divides tp*etp)
    etp: int = 1                   # per-expert tensor parallel
    serve_tp: int = 0              # cap on decode-time TP (0 = whole pod);
                                   # RWKV needs whole heads per shard
    fused_comm: bool = False       # route attn_block/dense_ffn through the
                                   # collective-fused kernels (ring attention
                                   # over cp, matmul gather-prologues /
                                   # scatter-epilogues over tp)

    # long-context capability marker (sub-quadratic attention memory)
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.n_experts and self.d_ff_expert == 0:
            object.__setattr__(self, "d_ff_expert", self.d_ff)

    # ------------------------------------------------------------ structure
    @property
    def model_parallel(self) -> int:
        """Total model-axis extent (= tp for dense; ep*etp for MoE)."""
        return self.ep * self.etp if self.n_experts else self.tp

    @property
    def n_experts_padded(self) -> int:
        if not self.n_experts:
            return 0
        return int(math.ceil(self.n_experts / self.ep) * self.ep)

    def mixers(self) -> list[str]:
        """Per-layer mixer kinds."""
        if not self.mixer_pattern:
            return [ATTN] * self.n_layers
        pat = self.mixer_pattern
        reps = int(math.ceil(self.n_layers / len(pat)))
        full = (pat * reps)[: self.n_layers]
        return [{"A": ATTN, "m": MAMBA, "r": RWKV}[c] for c in full]

    def ffns(self) -> list[str]:
        """Per-layer FFN kinds."""
        mixers = self.mixers()
        out = []
        for i in range(self.n_layers):
            if mixers[i] == RWKV:
                out.append(RWKVCM)
            elif self.n_experts and (i % self.moe_period == self.moe_period - 1):
                out.append(MOE)
            else:
                out.append(DENSE)
        return out

    def windows(self) -> np.ndarray:
        """Per-layer attention windows (-1 = full)."""
        w = np.full(self.n_layers, self.window, dtype=np.int32)
        if self.local_global_ratio:
            r = self.local_global_ratio
            for i in range(self.n_layers):
                w[i] = FULL_WINDOW if (i % (r + 1)) == r else self.local_window
        return w

    def unit(self) -> int:
        """Smallest repeating (mixer, ffn) unit length that divides n_layers.

        Windows are data (passed as scan xs), so they do not affect the unit.
        """
        plan = list(zip(self.mixers(), self.ffns()))
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p:
                continue
            if all(plan[i] == plan[i % p] for i in range(self.n_layers)):
                return p
        return self.n_layers

    # -------------------------------------------------------------- scaling
    def scaled_for_smoke(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests (single device)."""
        unit = self.unit()
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 * unit),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=96,
            d_ff_expert=96 if self.n_experts else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            n_enc_layers=min(self.n_enc_layers, 2),
            frontend_tokens=8 if self.frontend else 0,
            frontend_dim=32 if self.frontend else 0,
            local_window=8,
            window=8 if self.window != FULL_WINDOW else FULL_WINDOW,
            rwkv_head_dim=16,
            tp=1, ep=1, etp=1,
        )

    # ------------------------------------------------------------ accounting
    def param_count(self) -> int:
        """Exact parameter count (embeddings included)."""
        D, H, KV, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        total = self.vocab_size * D  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * D
        d_in = self.mamba_expand * D

        for mixer, ffn in zip(self.mixers(), self.ffns()):
            if mixer == ATTN:
                total += D * H * hd + 2 * D * KV * hd + H * hd * D
                if self.qk_norm:
                    total += 2 * hd
            elif mixer == MAMBA:
                total += D * 2 * d_in          # in_proj
                total += d_in * self.conv_kernel  # depthwise conv
                total += d_in * (2 * self.d_state + 1)  # x_proj(B,C) + dt
                total += d_in * self.d_state + d_in     # A_log, D
                total += d_in * D              # out_proj
            elif mixer == RWKV:
                total += 5 * D * D             # r,k,v,g,out
                total += 2 * D                 # decay base, bonus u
            if ffn == DENSE:
                total += 3 * D * self.d_ff
            elif ffn == RWKVCM:
                total += D * D + 2 * D * self.d_ff   # receptance + k/v
            elif ffn == MOE:
                total += self.n_experts * 3 * D * self.d_ff_expert
                total += D * self.n_experts    # router
                if self.n_shared_experts:
                    total += self.n_shared_experts * 3 * D * self.d_ff_expert
            total += 2 * D                     # two norms per layer
        if self.is_encoder_decoder:
            # encoder layers (attn + dense ffn) + cross-attention in decoder
            enc = self.n_enc_layers * (
                D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * self.d_ff + 2 * D)
            cross = self.n_layers * (D * H * hd + 2 * D * KV * hd + H * hd * D + D)
            total += enc + cross
        if self.frontend:
            total += (self.frontend_dim or D) * D
        total += D  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(1 for f in self.ffns() if f == MOE)
        unused = (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff_expert
        return int(full - n_moe_layers * unused)
