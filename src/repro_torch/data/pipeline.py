"""Deterministic sharded synthetic data pipeline.

A copy of ``repro.data.pipeline`` (NumPy only): every (step, shard) pair
maps to a unique counter-based stream (a splitmix64-style hash), so shards
are disjoint by construction, resuming needs only the step number, and a
different data-parallel degree re-partitions the same global stream. The
stream mimics a tokenized corpus: Zipfian token ids, document breaks
(label -1), next-token labels, and the frontend stubs (patches / frames)
hashed from the same counters. Batches are NumPy arrays, bit-identical to
the JAX package's; the trainer places them on the cube.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig

_MASK = (1 << 64) - 1


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def _hash_u64(counters: np.ndarray, salt: int) -> np.ndarray:
    return _splitmix64((counters.astype(np.uint64) ^ np.uint64(salt)))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    doc_len_mean: int = 512


class TokenStream:
    """Global synthetic stream; slice per host/shard as needed."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        self.cfg, self.dc = cfg, dc

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        dc = self.dc
        B, S = dc.global_batch, dc.seq_len
        base = (np.uint64(step) << np.uint64(32)) ^ np.uint64(dc.seed)
        counters = (base + np.arange(B * (S + 1), dtype=np.uint64)
                    ).reshape(B, S + 1)
        u = _hash_u64(counters, 0xA5A5)
        # Zipf-ish: id = floor(V * (u01 ** 3)) concentrates mass at low ids
        u01 = (u >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        ids = np.minimum((dc.vocab_size * (u01 ** 3.0)).astype(np.int64),
                         dc.vocab_size - 1)
        # document breaks -> loss masking across docs (label -1)
        brk = (_hash_u64(counters, 0x5A5A) % np.uint64(dc.doc_len_mean)) == 0
        tokens = ids[:, :S].astype(np.int32)
        labels = ids[:, 1:].astype(np.int32)
        labels = np.where(brk[:, 1:], -1, labels)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.frontend == "patch":
            F, fd = self.cfg.frontend_tokens, self.cfg.frontend_dim
            pc = (base + np.uint64(1 << 20)
                  + np.arange(B * F * fd, dtype=np.uint64)).reshape(B, F, fd)
            out["patches"] = (
                (_hash_u64(pc, 0x77) >> np.uint64(40)).astype(np.float32)
                / float(1 << 24) - 0.5)
            # patch positions carry no next-token loss
            out["labels"][:, :F] = -1
        if self.cfg.is_encoder_decoder:
            fd = self.cfg.frontend_dim
            fc = (base + np.uint64(1 << 21)
                  + np.arange(B * S * fd, dtype=np.uint64)).reshape(B, S, fd)
            out["frames"] = (
                (_hash_u64(fc, 0x99) >> np.uint64(40)).astype(np.float32)
                / float(1 << 24) - 0.5)
        return out

    def shard_batch_at(self, step: int, shard: int, n_shards: int):
        """The rows of the global batch owned by ``shard`` -- what each host
        feeds its local devices. Disjoint across shards by slicing."""
        g = self.global_batch_at(step)
        B = self.dc.global_batch
        if B % n_shards:
            raise ValueError(f"global batch {B} does not split into "
                             f"{n_shards} shards")
        lo = shard * (B // n_shards)
        hi = lo + B // n_shards
        return {k: v[lo:hi] for k, v in g.items()}

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.global_batch_at(step)
            step += 1
