"""Collective-fused flows: comm woven through compute, registry-first.

The counterpart of ``repro.kernels.collective``: ring-rotation flows whose
per-hop deliveries feed compute directly, registered in the algorithm
registry (``ring.py``) so they dispatch and trace like the Table II stages.

* :func:`ring_attention` -- sequence-parallel attention; kv blocks rotate
  while the flash kernel's partial form consumes them (``ring_fused``).
* :func:`all_gather_matmul` -- per-block prologue compute fused onto a
  ring gather (``ag_prologue``).
* :func:`matmul_reduce_scatter` -- lazy-tile matmul epilogue fused onto a
  ring reduce-scatter (``rs_epilogue``).

``FUSED_ENTRIES`` is the accounting surface: the conformance meta-test
needs one sweep cell per entry.
"""
from repro_torch.kernels.collective import ring as _ring  # registers flows
from repro_torch.kernels.collective.attention import (RING_ATTN_TOL,
                                                      ring_attention)
from repro_torch.kernels.collective.matmul import (all_gather_matmul,
                                                   matmul_reduce_scatter)
from repro_torch.kernels.collective.ring import dispatch_fused, take_block

# (primitive, registry name, bit_identical?) -- the registered fused flows
FUSED_ENTRIES = (
    ("all_gather", "ring_fused", True),       # pure movement w/o consumer
    ("all_gather", "ag_prologue", True),      # row-wise map commutes
    ("reduce_scatter", "rs_epilogue", False),  # ring sum order differs
)

__all__ = [
    "FUSED_ENTRIES", "RING_ATTN_TOL", "all_gather_matmul", "dispatch_fused",
    "matmul_reduce_scatter", "ring_attention", "take_block",
]
