"""The port's BERT data pipeline against ``repro.data``: the same seed
gives byte-identical shards and vocabularies, and the loaders yield the
same batches and cursors, across an epoch boundary and through a resume
from a saved cursor.  Both run numpy only."""
import time

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro.data import tokenizer as jtok
from repro_torch.data import pipeline as tpipe
from repro_torch.data import tokenizer as ttok


@pytest.mark.parametrize("seq_len,n_pred", [(128, 20), (512, 80)])
def test_shards_are_byte_identical(tmp_path, monkeypatch, seq_len, n_pred):
    """``np.savez`` stamps each zip member with the clock: both writers see
    one frozen clock, so the bytes compare the contents alone."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    kw = dict(seq_len=seq_len, n_predictions=n_pred, n_docs=60,
              vocab_size=30522, n_shards=4, seed=3)
    jpipe.prepare_bert_data(str(tmp_path / "ref"), **kw)
    tpipe.prepare_bert_data(str(tmp_path / "port"), **kw)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 6   # 4 shards, index.json, vocab.json
    for name in names:
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_examples_and_tokenizer_match():
    docs = jtok.synth_corpus(n_docs=20, seed=5)
    assert ttok.synth_corpus(n_docs=20, seed=5) == docs
    corpus = [s for d in docs for s in d]
    jt = jtok.train_wordpiece(corpus, vocab_size=600)
    tt = ttok.train_wordpiece(corpus, vocab_size=600)
    assert tt.vocab == jt.vocab
    ids = [[tt.encode(s) for s in d] for d in docs]
    assert ids == [[jt.encode(s) for s in d] for d in docs]
    cfg = dict(seq_len=64, n_predictions=10)
    want = jpipe.build_bert_examples(ids, jt, jpipe.BertExampleConfig(**cfg),
                                     seed=2)
    got = tpipe.build_bert_examples(ids, tt, tpipe.BertExampleConfig(**cfg),
                                    seed=2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_loader_batches_and_cursors_match_across_epochs(tmp_path):
    tpipe.prepare_bert_data(str(tmp_path), seq_len=128, n_docs=40,
                            vocab_size=512, n_shards=4, seed=1)
    kw = dict(worker=1, n_workers=2, batch=8, seed=4)
    jl = jpipe.ShardedLoader(str(tmp_path), **kw)
    tl = tpipe.ShardedLoader(str(tmp_path), **kw)
    assert tl.batches_per_epoch == jl.batches_per_epoch >= 2
    saved = None
    for i in range(2 * jl.batches_per_epoch + 3):   # crosses two epochs
        want, got = next(jl), next(tl)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert tl.state_dict() == jl.state_dict()
        if i == jl.batches_per_epoch + 1:
            saved = tl.state_dict()
            rest = [next(jl) for _ in range(3)]
            for _ in range(3):
                next(tl)
    resumed = tpipe.ShardedLoader(str(tmp_path), **kw)
    resumed.load_state_dict(saved)
    for want in rest:
        got = next(resumed)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        resumed.load_state_dict(dict(saved, seed=99))
