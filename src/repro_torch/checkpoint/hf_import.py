"""Hugging Face checkpoint import onto the ``configs/`` param trees.

The counterpart of ``repro.checkpoint.hf_import``: readers and writers for
the two HF weight formats -- **safetensors** (8-byte LE header length +
JSON header + raw buffer) and **pytorch_model.bin** (a zip archive whose
``data.pkl`` references per-tensor storage files through pickle persistent
ids) -- plus the key-layout mapping from transformer ``state_dict`` names
onto this repo's stacked unit trees (:func:`repro_torch.models.params.
param_defs`). Tensors are CPU torch tensors, so BF16 (the dtype HF ships
Qwen3 in) is read and written as raw 16-bit words with no NumPy dtype. The
``.bin`` reader unpickles with the standard library, every torch global
resolved to a stub (the file's pickle runs no torch code); the writer is
``torch.save``, whose files the JAX package's reader takes too.

Mapping conventions (``docs/CHECKPOINT.md`` has the matrix):

* torch ``Linear`` stores ``(out, in)`` and applies ``x @ W.T``; this repo
  stores the applied orientation, so every projection imports transposed.
* RMSNorm scales here are residual (``rms_norm`` applies ``1 + w``), so HF
  norm weights import as ``w - 1`` (f32 arithmetic).
* ``wkv`` interleaves k/v per head -- column layout ``(KV, 2, hd)`` -- so
  k_proj/v_proj stack head-wise, not concatenate.
* The vocab axis pads to ``vocab_padded(cfg, topo)`` with zero rows; the
  router pads expert columns to ``n_experts_padded`` with a large negative
  constant so softmax routes nothing to padding experts.
* Layer ``l`` lands at stack index ``l // unit``, position ``p{l % unit}``.

Supported: attention mixers with dense FFNs (LLaMA-style split projections
and the phi3 fused ``qkv_proj`` / ``gate_up_proj`` forms) and MoE
(mixtral ``block_sparse_moe`` and qwen2-moe ``mlp.experts`` layouts,
shared experts included). RWKV / Mamba mixers and encoder-decoder trees
raise :class:`UnsupportedArchitecture`, as in the reference.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import struct
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import layout, reshard
from repro_torch.models.config import ATTN, DENSE, MOE, ModelConfig

ROUTER_PAD = -1e9  # routed probability of a padding expert underflows to 0


class UnsupportedArchitecture(NotImplementedError):
    """The config's param tree has no HF key mapping (yet)."""


def _tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (tensor or NumPy array)."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x))


def _from_bytes(raw, dtype: torch.dtype, numel: int) -> torch.Tensor:
    """``numel`` elements of ``dtype`` from a byte buffer, in memory of
    their own."""
    if numel == 0:
        return torch.empty(0, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype, count=numel)


# ====================================================== safetensors format
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Parse a ``.safetensors`` file into ``{name: CPU tensor}``, each
    tensor read straight into memory of its own."""
    out = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            try:
                dtype = _ST_DTYPES[meta["dtype"]]
            except KeyError:
                raise ValueError(f"unsupported safetensors dtype "
                                 f"{meta['dtype']!r}") from None
            lo, hi = meta["data_offsets"]
            shape = [int(s) for s in meta["shape"]]
            raw = bytearray(hi - lo)
            f.seek(8 + hlen + lo)
            if f.readinto(raw) != hi - lo:
                raise ValueError(f"{path}: {name} runs past the end")
            out[name] = _from_bytes(raw, dtype,
                                    math.prod(shape)).reshape(shape)
    return out


def write_safetensors(path: str, tensors: dict, *,
                      metadata: dict[str, str] | None = None) -> None:
    """Write ``{name: tensor or array}`` as a ``.safetensors`` file (the
    reference's header layout, names sorted)."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        dtype = t.dtype if isinstance(t, torch.Tensor) else _tensor(t).dtype
        if dtype not in _ST_NAMES:
            raise ValueError(f"unsupported dtype {dtype} for safetensors")
        nbytes = math.prod(t.shape) * torch.empty(
            (), dtype=dtype).element_size()
        header[name] = {
            "dtype": _ST_NAMES[dtype],
            "shape": [int(s) for s in t.shape],
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for name in sorted(tensors):     # one tensor's bytes at a time
            t = _tensor(tensors[name]).contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)


# ================================================= pytorch_model.bin format
_TORCH_DTYPES = {
    "FloatStorage": torch.float32, "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16, "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64, "IntStorage": torch.int32,
    "ShortStorage": torch.int16, "CharStorage": torch.int8,
    "ByteStorage": torch.uint8, "BoolStorage": torch.bool,
}


class _StorageStub:
    """Stands in for a ``torch.<T>Storage`` class object in the pickle."""

    def __init__(self, name: str):
        self.name = name


class _TensorStub:
    """Result of ``_rebuild_tensor_v2``: enough to realize the tensor."""

    def __init__(self, storage_key, dtype, offset, size, stride):
        self.storage_key = storage_key
        self.dtype = dtype
        self.offset = int(offset)
        self.size = tuple(int(s) for s in size)
        self.stride = tuple(int(s) for s in stride)


def _rebuild_stub(storage, offset, size, stride, *args):
    key, dtype = storage
    return _TensorStub(key, dtype, offset, size, stride)


class _TorchUnpickler(pickle.Unpickler):
    """Unpickles a torch ``data.pkl`` with stubs only: any ``torch.*``
    global resolves to a stub, and persistent ids resolve to (storage key,
    dtype) pairs realized from the archive's ``data/<key>`` entries."""

    def find_class(self, module: str, name: str):
        if module.startswith("torch"):
            if name.endswith("Storage"):
                return _StorageStub(name)
            if name in ("_rebuild_tensor_v2", "_rebuild_tensor"):
                return _rebuild_stub
            return _StorageStub(f"{module}.{name}")
        if module == "collections" and name == "OrderedDict":
            return dict
        raise pickle.UnpicklingError(
            f"pytorch_model.bin pickles non-torch global {module}.{name}")

    def persistent_load(self, pid):
        kind, storage_type, key, _location, _numel = pid
        if kind != "storage":
            raise pickle.UnpicklingError(f"unknown persistent id {kind!r}")
        name = storage_type.name if isinstance(storage_type, _StorageStub) \
            else str(storage_type)
        try:
            return (key, _TORCH_DTYPES[name])
        except KeyError:
            raise pickle.UnpicklingError(
                f"unsupported storage type {name!r}") from None


def read_pytorch_bin(path: str) -> dict[str, torch.Tensor]:
    """Parse a ``pytorch_model.bin`` (zip serialization) into
    ``{name: CPU tensor}`` without running the pickle's torch code."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        pkl_name = next(n for n in zf.namelist()
                        if n.endswith("/data.pkl"))
        prefix = pkl_name[: -len("data.pkl")]
        with zf.open(pkl_name) as f:
            state = _TorchUnpickler(f).load()
        for name, t in state.items():
            if not isinstance(t, _TensorStub):
                continue
            raw = zf.read(f"{prefix}data/{t.storage_key}")
            item = torch.empty((), dtype=t.dtype).element_size()
            flat = _from_bytes(raw, t.dtype, len(raw) // item)
            out[name] = flat.as_strided(t.size, t.stride, t.offset).clone()
    return out


def write_pytorch_bin(path: str, tensors: dict) -> None:
    """Write ``{name: tensor or array}`` in torch's zip serialization
    (``torch.save``), readable by :func:`read_pytorch_bin` and by the JAX
    package's reader (f32 and the other NumPy types)."""
    torch.save({name: _tensor(tensors[name]).contiguous().clone()
                for name in sorted(tensors)}, path)


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read either HF weight format, sniffed by extension then content."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if zipfile.is_zipfile(path):
        return read_pytorch_bin(path)
    return read_safetensors(path)


# ========================================================= key-layout maps
def _t(w) -> torch.Tensor:
    return _tensor(w).t().contiguous()


def _norm(w) -> torch.Tensor:
    return _tensor(w).to(torch.float32) - 1.0


class _LayerView:
    """Pops a layer's keys out of the flat state dict, several aliases per
    logical tensor (llama/mixtral/qwen2-moe/phi3 spellings)."""

    def __init__(self, sd: dict, prefix: str):
        self.sd = sd
        self.prefix = prefix

    def take(self, *names: str, required: bool = True):
        for n in names:
            full = self.prefix + n
            if full in self.sd:
                return _tensor(self.sd.pop(full))
        if required:
            raise KeyError(
                f"none of {[self.prefix + n for n in names]} present "
                "in the checkpoint")
        return None


def _attn_from_hf(lw: _LayerView, cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fused = lw.take("self_attn.qkv_proj.weight", required=False)
    if fused is not None:  # phi3: rows are [q; k; v]
        q = fused[: H * hd]
        k = fused[H * hd: H * hd + KV * hd]
        v = fused[H * hd + KV * hd:]
    else:
        q = lw.take("self_attn.q_proj.weight", "attention.wq.weight")
        k = lw.take("self_attn.k_proj.weight", "attention.wk.weight")
        v = lw.take("self_attn.v_proj.weight", "attention.wv.weight")
    kT = _t(k).reshape(D, KV, hd)
    vT = _t(v).reshape(D, KV, hd)
    out = {
        "ln": _norm(lw.take("input_layernorm.weight",
                            "attention_norm.weight")),
        "wq": _t(q),
        "wkv": torch.stack([kT, vT], dim=2).reshape(D, 2 * KV * hd),
        "wo": _t(lw.take("self_attn.o_proj.weight",
                         "attention.wo.weight")),
    }
    if cfg.qk_norm:
        out["q_norm"] = _norm(lw.take("self_attn.q_norm.weight"))
        out["k_norm"] = _norm(lw.take("self_attn.k_norm.weight"))
    return out


def _dense_from_hf(lw: _LayerView, cfg: ModelConfig) -> dict:
    fln = _norm(lw.take("post_attention_layernorm.weight",
                        "ffn_norm.weight"))
    fused = lw.take("mlp.gate_up_proj.weight", required=False)
    if fused is not None:  # phi3: rows are [gate; up]
        g, u = fused[: cfg.d_ff], fused[cfg.d_ff:]
    else:
        g = lw.take("mlp.gate_proj.weight", "feed_forward.w1.weight")
        u = lw.take("mlp.up_proj.weight", "feed_forward.w3.weight")
    d = lw.take("mlp.down_proj.weight", "feed_forward.w2.weight")
    return {"fln": fln, "wg": _t(g), "wu": _t(u), "wd": _t(d)}


def _moe_from_hf(lw: _LayerView, cfg: ModelConfig) -> dict:
    D, Fe, E, Ep = (cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                    cfg.n_experts_padded)
    router = _t(lw.take("block_sparse_moe.gate.weight", "mlp.gate.weight"))
    if Ep > E:
        pad = torch.full((D, Ep - E), ROUTER_PAD, dtype=router.dtype)
        router = torch.cat([router, pad], dim=1)
    gates, ups, downs = [], [], []
    for e in range(E):
        gates.append(_t(lw.take(
            f"block_sparse_moe.experts.{e}.w1.weight",
            f"mlp.experts.{e}.gate_proj.weight")))
        ups.append(_t(lw.take(
            f"block_sparse_moe.experts.{e}.w3.weight",
            f"mlp.experts.{e}.up_proj.weight")))
        downs.append(_t(lw.take(
            f"block_sparse_moe.experts.{e}.w2.weight",
            f"mlp.experts.{e}.down_proj.weight")))
    for _ in range(Ep - E):
        gates.append(torch.zeros((D, Fe), dtype=gates[0].dtype))
        ups.append(torch.zeros((D, Fe), dtype=ups[0].dtype))
        downs.append(torch.zeros((Fe, D), dtype=downs[0].dtype))
    out = {
        "fln": _norm(lw.take("post_attention_layernorm.weight",
                             "ffn_norm.weight")),
        "router": router,
        "we_g": torch.stack(gates), "we_u": torch.stack(ups),
        "we_d": torch.stack(downs),
    }
    if cfg.n_shared_experts:
        out["ws_g"] = _t(lw.take("mlp.shared_expert.gate_proj.weight"))
        out["ws_u"] = _t(lw.take("mlp.shared_expert.up_proj.weight"))
        out["ws_d"] = _t(lw.take("mlp.shared_expert.down_proj.weight"))
        lw.take("mlp.shared_expert_gate.weight", required=False)
    return out


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    if a.shape[0] == n:
        return a
    pad = torch.zeros((n - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype)
    return torch.cat([a, pad], dim=0)


def import_state_dict(sd: dict, cfg: ModelConfig, topo=None, *,
                      dtype: torch.dtype = torch.float32,
                      strict: bool = True) -> dict:
    """Map an HF ``state_dict`` (tensors or arrays) onto this repo's param
    tree: CPU tensors of global shapes for ``topo`` -- pass the topology
    the params will live on so the vocab axis pads to its ``tp_size``;
    ``None`` means no padding.

    ``strict`` raises if checkpoint keys remain unconsumed after mapping
    (catching silent architecture drift); rotary ``inv_freq`` buffers are
    always ignored.
    """
    mixers, ffns = cfg.mixers(), cfg.ffns()
    if cfg.is_encoder_decoder or any(m != ATTN for m in mixers) \
            or any(f not in (DENSE, MOE) for f in ffns):
        raise UnsupportedArchitecture(
            f"{cfg.name}: HF import supports attention mixers with "
            "dense/MoE FFNs; mamba/rwkv/encoder-decoder trees have no "
            "key mapping yet")

    tp_size = topo.tp_size if topo is not None else 1
    Vp = int(math.ceil(cfg.vocab_size / tp_size) * tp_size)

    sd = dict(sd)
    for k in [k for k in sd if k.endswith("rotary_emb.inv_freq")]:
        del sd[k]

    unit = cfg.unit()
    n_units = cfg.n_layers // unit
    per_pos: dict[str, list] = {f"p{p}": [None] * n_units
                                for p in range(unit)}
    for layer in range(cfg.n_layers):
        lw = _LayerView(sd, f"model.layers.{layer}.")
        leaves = dict(_attn_from_hf(lw, cfg))
        leaves.update(_moe_from_hf(lw, cfg) if ffns[layer] == MOE
                      else _dense_from_hf(lw, cfg))
        per_pos[f"p{layer % unit}"][layer // unit] = leaves

    units = {pos: {name: torch.stack([l[name].to(dtype) for l in layers])
                   for name in layers[0]}
             for pos, layers in per_pos.items()}

    root = _LayerView(sd, "")
    embed = root.take("model.embed_tokens.weight", "tok_embeddings.weight")
    tree: dict[str, Any] = {
        "embed": _pad_rows(embed, Vp).to(dtype),
        "units": units,
        "final_norm": _norm(root.take("model.norm.weight",
                                      "norm.weight")).to(dtype),
    }
    if not cfg.tie_embeddings:
        head = root.take("lm_head.weight", "output.weight", required=False)
        if head is None:  # tied on the HF side: reuse the embedding
            head = embed
        tree["lm_head"] = _pad_rows(head, Vp).t().contiguous().to(dtype)
    else:
        root.take("lm_head.weight", required=False)

    if strict and sd:
        extra = sorted(sd)[:8]
        raise ValueError(
            f"{len(sd)} checkpoint keys have no mapping onto {cfg.name} "
            f"(first few: {extra}); pass strict=False to ignore")
    return tree


def export_state_dict(params, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The inverse map: this repo's param tree of global tensors (or
    arrays) -> HF-style ``state_dict`` of CPU tensors (split llama-style
    projections, un-padded vocab). ``import_state_dict(export_state_dict(
    p)) == p`` exactly for attention+dense architectures whose vocab needs
    no padding."""
    mixers, ffns = cfg.mixers(), cfg.ffns()
    if cfg.is_encoder_decoder or any(m != ATTN for m in mixers) \
            or any(f != DENSE for f in ffns):
        raise UnsupportedArchitecture(
            f"{cfg.name}: HF export supports attention+dense trees")
    D, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    V = cfg.vocab_size
    unit = cfg.unit()
    sd: dict[str, torch.Tensor] = {}
    sd["model.embed_tokens.weight"] = _tensor(params["embed"])[:V].clone()
    sd["model.norm.weight"] = _tensor(params["final_norm"]) + 1.0
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _t(_tensor(params["lm_head"])[:, :V])
    units = {pos: {k: _tensor(v) for k, v in leaf.items()}
             for pos, leaf in params["units"].items()}
    for layer in range(cfg.n_layers):
        w = units[f"p{layer % unit}"]
        u = layer // unit
        pre = f"model.layers.{layer}."
        sd[pre + "input_layernorm.weight"] = w["ln"][u] + 1.0
        sd[pre + "self_attn.q_proj.weight"] = _t(w["wq"][u])
        kv = w["wkv"][u].reshape(D, KV, 2, hd)
        sd[pre + "self_attn.k_proj.weight"] = _t(
            kv[:, :, 0].reshape(D, KV * hd))
        sd[pre + "self_attn.v_proj.weight"] = _t(
            kv[:, :, 1].reshape(D, KV * hd))
        sd[pre + "self_attn.o_proj.weight"] = _t(w["wo"][u])
        if cfg.qk_norm:
            sd[pre + "self_attn.q_norm.weight"] = w["q_norm"][u] + 1.0
            sd[pre + "self_attn.k_norm.weight"] = w["k_norm"][u] + 1.0
        sd[pre + "post_attention_layernorm.weight"] = w["fln"][u] + 1.0
        sd[pre + "mlp.gate_proj.weight"] = _t(w["wg"][u])
        sd[pre + "mlp.up_proj.weight"] = _t(w["wu"][u])
        sd[pre + "mlp.down_proj.weight"] = _t(w["wd"][u])
    return sd


def import_checkpoint(path: str, cfg: ModelConfig, topo=None, *,
                      dtype: torch.dtype = torch.float32,
                      strict: bool = True, specs=None, device=None) -> dict:
    """Read an HF weight file and map it onto the param tree. With
    ``topo`` *and* ``specs`` (the target ``param_specs``), leaves are
    placed onto the cube on ``device`` (CUDA unless the CPU is asked for)
    through one rooted-scatter CommProgram named ``hf-import`` -- the
    planned path elastic restore takes; otherwise CPU tensors return."""
    tree = import_state_dict(read_state_dict(path), cfg, topo,
                             dtype=dtype, strict=strict)
    if topo is not None and specs is not None:
        flat = list(layout.flatten(tree))
        leaves = [leaf for _, leaf in flat]
        placed = reshard.scatter_to_cube(
            topo, leaves, reshard.flatten_specs(specs, len(leaves)),
            name="hf-import", device=device)
        return layout.tree_from_paths([p for p, _ in flat], placed)
    return tree


__all__ = [
    "ROUTER_PAD", "UnsupportedArchitecture", "export_state_dict",
    "import_checkpoint", "import_state_dict", "read_pytorch_bin",
    "read_safetensors", "read_state_dict", "write_pytorch_bin",
    "write_safetensors",
]
