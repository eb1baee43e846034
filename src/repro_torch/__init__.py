"""PyTorch/CUDA port of the PID-Comm reproduction (``repro``).

The PE hypercube lives in one process: every tensor on the cube carries the
cube's leading axes ``(*cube.dim_sizes, *per_pe_shape)``, a collective is a
data movement across those axes, and attention runs on a hand-written
Hopper kernel (``repro_torch.kernels.attention``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device="cpu"`` is
    asked for. Without a GPU an entry point raises instead of quietly
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is visible; "
            "pass device='cpu' (launcher: --device cpu) to run on the CPU")
    return dev
