"""Architecture registry of the port, keyed like ``repro.configs``.

Every architecture of the reference resolves (``PORTED``).
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "mixtral_8x7b",
    "qwen2_moe_a2_7b",
    "qwen3_1_7b",
    "gemma3_1b",
    "internlm2_20b",
    "phi3_mini_3_8b",
    "llava_next_34b",
    "whisper_base",
    "rwkv6_7b",
    "jamba_1_5_large",
)

# architectures whose every layer kind has a port
PORTED = ("qwen3_1_7b", "qwen2_moe_a2_7b", "mixtral_8x7b", "rwkv6_7b",
          "phi3_mini_3_8b", "gemma3_1b", "internlm2_20b", "whisper_base",
          "llava_next_34b", "jamba_1_5_large")

ALIASES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma3-1b": "gemma3_1b",
    "internlm2-20b": "internlm2_20b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "llava-next-34b": "llava_next_34b",
    "whisper-base": "whisper_base",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
}


def get(arch: str):
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; know {sorted(ALIASES)}")
    if mod not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; ported: "
            f"{list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
