"""The port's synthetic token stream (``repro_torch.data.pipeline``) is the
JAX package's bit for bit: the same (step, shard) counters give the same
tokens, labels and frontend stubs."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get as jax_get
from repro.data import pipeline as jax_pipeline

from repro_torch import configs
from repro_torch.data import pipeline


def _streams(arch="qwen3-1.7b", **dc):
    d = dict(seq_len=64, global_batch=8, vocab_size=151936, seed=3,
             doc_len_mean=32)
    d.update(dc)
    return (pipeline.TokenStream(configs.get(arch),
                                 pipeline.DataConfig(**d)),
            jax_pipeline.TokenStream(jax_get(arch),
                                     jax_pipeline.DataConfig(**d)))


@pytest.mark.parametrize("step", [0, 1, 7, 1000, 2 ** 20 + 3])
def test_global_batch_bit_identical(step):
    mine, ref = _streams()
    got, want = mine.global_batch_at(step), ref.global_batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["labels"] == -1).any()          # document breaks masked


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shards_bit_identical_and_disjoint(n_shards):
    mine, ref = _streams()
    parts = []
    for shard in range(n_shards):
        got = mine.shard_batch_at(5, shard, n_shards)
        want = ref.shard_batch_at(5, shard, n_shards)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        parts.append(got["tokens"])
    np.testing.assert_array_equal(np.concatenate(parts),
                                  mine.global_batch_at(5)["tokens"])


def test_batches_iterator_and_frontend_stubs():
    mine, ref = _streams()
    it_m, it_r = mine.batches(2), ref.batches(2)
    for _ in range(3):
        a, b = next(it_m), next(it_r)
        np.testing.assert_array_equal(a["labels"], b["labels"])
    # the patch / frames stubs of the frontends hash the same counters
    for fe in ({"frontend": "patch", "frontend_tokens": 4,
                "frontend_dim": 6},
               {"is_encoder_decoder": True, "frontend_dim": 5}):
        jcfg = dataclasses.replace(jax_get("qwen3-1.7b"), **fe)
        pcfg = dataclasses.replace(configs.get("qwen3-1.7b"), **fe)
        d = pipeline.DataConfig(seq_len=8, global_batch=2, vocab_size=100)
        got = pipeline.TokenStream(pcfg, d).global_batch_at(1)
        want = jax_pipeline.TokenStream(
            jcfg, jax_pipeline.DataConfig(**dataclasses.asdict(d))
        ).global_batch_at(1)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_uneven_shards_raise():
    mine, _ = _streams()
    with pytest.raises(ValueError):
        mine.shard_batch_at(0, 0, 3)
