"""The port's tokenizers and batch pipeline against the JAX package's: the
same texts must give byte-identical batches, in the same order, padded and
packed, over several epochs."""

import numpy as np
import pytest

from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.data import pipeline as jax_pipeline
from dlti_tpu.data.tokenizer import get_tokenizer as jax_get_tokenizer
from dlti_tpu_torch.data import get_tokenizer, make_batches, pipeline


def _texts(n=50, seed=0):
    rng = np.random.default_rng(seed)
    words = ["the", "cat", "ünïcødé", "tokens", "def", "f(x):", "return", "€", "\n"]
    return [" ".join(rng.choice(words, rng.integers(1, 40))) for _ in range(n)]


@pytest.mark.parametrize("name", ["byte", "id", "id:4096"])
def test_tokenizers_match_jax(name):
    mine, ref = get_tokenizer(name), jax_get_tokenizer(name)
    assert (mine.vocab_size, mine.pad_id, mine.bos_id, mine.eos_id) == (
        ref.vocab_size, ref.pad_id, ref.bos_id, ref.eos_id)
    for t in _texts(10) + ["<5> <70000> plain"]:
        ids = mine.encode(t, add_bos=True, add_eos=True)
        assert ids == ref.encode(t, add_bos=True, add_eos=True)
        assert mine.decode(ids) == ref.decode(ids)


def test_hub_tokenizer_names_raise():
    with pytest.raises(ValueError, match="hub"):
        get_tokenizer("meta-llama/Llama-2-7b-hf")
    with pytest.raises(ValueError, match="id-tokenizer"):
        get_tokenizer("id:abc")


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("seq_len,bs,accum,seed", [(64, 2, 2, 0), (48, 3, 1, None)])
def test_make_batches_byte_identical_to_jax(pack, seq_len, bs, accum, seed):
    texts = _texts()
    tok = get_tokenizer("byte")
    mine = make_batches(texts, tok, seq_len=seq_len, micro_batch_size=bs,
                        grad_accum_steps=accum, shuffle_seed=seed, pack=pack)
    ref = jax_make_batches(texts, jax_get_tokenizer("byte"), seq_len=seq_len,
                           micro_batch_size=bs, grad_accum_steps=accum,
                           shuffle_seed=seed, shard_by_host=False, pack=pack)
    assert mine.steps_per_epoch() == ref.steps_per_epoch() > 0
    for epoch in range(2):
        got, want = list(mine.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
    skipped = list(mine.epoch(1, skip_steps=2))
    np.testing.assert_array_equal(skipped[0]["input_ids"],
                                  list(ref.epoch(1, skip_steps=2))[0]["input_ids"])


def test_partial_last_step_padding_matches_jax():
    texts = _texts(23)
    tok = get_tokenizer("byte")
    mine = make_batches(texts, tok, seq_len=32, micro_batch_size=4, grad_accum_steps=2)
    mine.drop_remainder = False
    ref = jax_make_batches(texts, jax_get_tokenizer("byte"), seq_len=32,
                           micro_batch_size=4, grad_accum_steps=2, shard_by_host=False)
    ref.drop_remainder = False
    got, want = list(mine.epoch(0)), list(ref.epoch(0))
    assert len(got) == len(want) == 3
    for k in got[-1]:
        np.testing.assert_array_equal(got[-1][k], want[-1][k])


def test_packing_helpers_match_jax():
    rng = np.random.default_rng(3)
    seqs = [list(rng.integers(3, 200, n)) for n in rng.integers(0, 50, 80)]
    got = pipeline.pack_sequences(seqs, 64, 0, open_rows=4)
    want = jax_pipeline.pack_sequences(seqs, 64, 0, open_rows=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    segs = got[2]
    np.testing.assert_array_equal(pipeline.packed_loss_mask(segs),
                                  jax_pipeline.packed_loss_mask(segs))
    np.testing.assert_array_equal(pipeline.packed_positions(segs),
                                  jax_pipeline.packed_positions(segs))
    ids, mask = pipeline.pad_to_batch(seqs[:5], 30, 0)
    rids, rmask = jax_pipeline.pad_to_batch(seqs[:5], 30, 0)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(mask, rmask)
