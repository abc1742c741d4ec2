"""The port's copies of the numpy-only data modules
(ddp_practice_tpu_torch/data/) against the JAX package's, bit for bit:
the synthetic Markov corpus, byte corpora, the epoch permutation, padding
and every batch of the LM loader for two epochs, shuffled and not, for
each shard of a 2-process split."""

import numpy as np
import pytest

from ddp_practice_tpu.data import lm_corpus as jc
from ddp_practice_tpu.data import sharding as js
from ddp_practice_tpu_torch.data import lm_corpus as tc
from ddp_practice_tpu_torch.data import sharding as ts


@pytest.mark.parametrize("seed", [0, 3407])
def test_synthetic_corpus_is_bit_equal(seed):
    a = jc.synthetic_token_corpus(20000, seed=seed)
    b = tc.synthetic_token_corpus(20000, seed=seed)
    assert a.tokens.dtype == b.tokens.dtype
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.vocab_size, a.name) == (b.vocab_size, b.name)
    np.testing.assert_array_equal(a.windows(31), b.windows(31))


def test_text_corpus_is_bit_equal(tmp_path):
    (tmp_path / "b.txt").write_bytes(b"second file\n")
    (tmp_path / "a.txt").write_bytes(bytes(range(256)))
    a = jc.load_text_corpus(str(tmp_path))
    b = tc.load_text_corpus(str(tmp_path))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.vocab_size, a.name) == (b.vocab_size, b.name)


@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_indices_and_padding_are_bit_equal(shuffle):
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(
            js.epoch_indices(101, seed=7, epoch=epoch, shuffle=shuffle),
            ts.epoch_indices(101, seed=7, epoch=epoch, shuffle=shuffle))
    idx = np.arange(13)
    for a, b in zip(js.pad_to_multiple(idx, 8), ts.pad_to_multiple(idx, 8)):
        np.testing.assert_array_equal(a, b)
    assert (js.ShardSpec(1, 4).local_slice(32)
            == ts.ShardSpec(1, 4).local_slice(32))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("rank", [0, 1])
def test_lm_loader_batches_are_bit_equal(shuffle, rank):
    tokens = jc.synthetic_token_corpus(12000, seed=1).tokens
    kw = dict(seq_len=31, global_batch_size=8, seed=5, shuffle=shuffle)
    ja = jc.LMDataLoader(jc.TokenCorpus(tokens, 64),
                         shard=js.ShardSpec(rank, 2), **kw)
    ta = tc.LMDataLoader(tc.TokenCorpus(tokens, 64),
                         shard=ts.ShardSpec(rank, 2), **kw)
    assert len(ja) == len(ta) > 2
    for epoch in (0, 1):
        ja.set_epoch(epoch)
        ta.set_epoch(epoch)
        jb, tb = list(ja), list(ta)
        assert len(jb) == len(tb) == len(ja)
        for x, y in zip(jb, tb):
            assert y["tokens"].dtype == np.int32 and y["tokens"].shape == (
                4, 32)
            np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(ja.epoch_plan()[0], ta.epoch_plan()[0])
