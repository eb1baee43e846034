"""Elastic checkpointing as collective programs (the port of
``repro.checkpoint``).

* :mod:`repro_torch.checkpoint.manager` -- the topology-bound
  :class:`CheckpointManager` surface (async save, elastic restore,
  deprecated positional shims) and the :class:`TrainState` container;
* :mod:`repro_torch.checkpoint.layout` -- on-disk step layout, manifest v2
  (leaf records + structural fingerprint), atomic finalize;
* :mod:`repro_torch.checkpoint.reshard` -- save / restore data movement as
  recorded rooted gather / scatter CommPrograms;
* :mod:`repro_torch.checkpoint.hf_import` -- Hugging Face safetensors /
  ``pytorch_model.bin`` import onto the ``configs/`` param trees.
"""
from repro_torch.checkpoint.manager import CheckpointManager, TrainState

__all__ = ["CheckpointManager", "TrainState"]
