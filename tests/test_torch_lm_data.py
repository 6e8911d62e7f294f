"""The port's causal-LM data (``repro_torch.data.pipeline``: ``LMStream``,
``lm_batches``, ``build_lm_examples``, ``prepare_lm_data``) against
``repro.data.pipeline``: the stream's token arrays are the reference's bit
for bit, a resumed stream replays the uninterrupted one's batches (twin of
``tests/test_faults.py::test_lm_stream_cursor_exact_resume``), packed
examples and their shards equal the reference's (twins of
``tests/test_data.py::test_packed_lm_examples`` and
``::test_prepare_lm_data_end_to_end``).  Both run numpy only."""
import time

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro.data import tokenizer as jtok
from repro_torch.data import pipeline as tpipe
from repro_torch.data import tokenizer as ttok
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


@pytest.mark.parametrize("seed,vocab,batch,seq", [(0, 512, 4, 64),
                                                  (7, 102400, 2, 33)])
def test_lm_stream_has_the_reference_bits(seed, vocab, batch, seq):
    """The same ``default_rng([seed, step])`` and ``choice(p=1/rank)``: each
    of the first five batches equal in shape, dtype and every token."""
    want, got = (jpipe.lm_batches(seed, vocab, batch, seq),
                 tpipe.lm_batches(seed, vocab, batch, seq))
    for _ in range(5):
        w, g = next(want)["tokens"], next(got)["tokens"]
        assert g.dtype == w.dtype == np.int32
        assert g.shape == w.shape == (batch, seq + 1)
        np.testing.assert_array_equal(g, w)
    assert got.state_dict() == want.state_dict() == {"step": 5, "seed": seed}


def test_lm_stream_cursor_exact_resume():
    """Twin of ``tests/test_faults.py:114``, and the port's stream resumed
    from the reference's cursor (the cursor is plain data in a
    checkpoint's extra)."""
    ref = tpipe.lm_batches(7, 256, 2, 8)
    for _ in range(5):
        next(ref)
    cursor = ref.state_dict()
    want = [next(ref)["tokens"] for _ in range(4)]
    fresh = tpipe.lm_batches(7, 256, 2, 8)
    fresh.load_state_dict(cursor)
    got = [next(fresh)["tokens"] for _ in range(4)]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    jref = jpipe.lm_batches(7, 256, 2, 8)
    for _ in range(5):
        next(jref)
    fresh = tpipe.lm_batches(7, 256, 2, 8)
    fresh.load_state_dict(jref.state_dict())
    np.testing.assert_array_equal(next(fresh)["tokens"],
                                  next(jref)["tokens"])


def test_lm_stream_rejects_a_foreign_cursor():
    stream = tpipe.lm_batches(3, 256, 2, 8)
    with pytest.raises(ValueError, match="seed 99"):
        stream.load_state_dict({"step": 4, "seed": 99})
    stream.load_state_dict({"step": 4})   # a cursor without a seed: taken
    assert stream.state_dict() == {"step": 4, "seed": 3}


@pytest.fixture(scope="module")
def corpus():
    docs = ttok.synth_corpus(n_docs=30, seed=3)
    assert docs == jtok.synth_corpus(n_docs=30, seed=3)
    text = [s for d in jtok.synth_corpus(n_docs=50, seed=0) for s in d]
    tok = ttok.train_wordpiece(text, vocab_size=2048)
    assert tok.vocab == jtok.train_wordpiece(text, vocab_size=2048).vocab
    return tok, [[tok.encode(s) for s in d] for d in docs]


def test_packed_lm_examples(corpus):
    """Twin of ``tests/test_data.py:113``, and the rows equal the
    reference's packing of the same documents (with and without an
    explicit separator)."""
    tok, docs = corpus
    ex = tpipe.build_lm_examples(docs, tok, seq_len=64)
    assert ex["tokens"].shape[1] == 65
    assert ex["tokens"].shape[0] > 5
    assert (ex["tokens"] >= 0).all() and (ex["tokens"] < len(tok)).all()
    assert (ex["tokens"] == tok.sep_id).sum() >= 25  # ~1 per document
    for kw in ({}, {"eos_id": 3}):
        want = jpipe.build_lm_examples(docs, tok, seq_len=64, **kw)
        got = tpipe.build_lm_examples(docs, tok, seq_len=64, **kw)
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    with pytest.raises(ValueError, match="smaller than one packed row"):
        tpipe.build_lm_examples(docs[:1], tok, seq_len=100_000)


def test_prepare_lm_data_end_to_end(tmp_path, monkeypatch):
    """Twin of ``tests/test_data.py:125``: the shards load through the
    loader as (4, 33) rows.  Written under one frozen clock (``np.savez``
    stamps each member with it), the port's files are the reference's
    byte for byte."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    kw = dict(seq_len=32, n_docs=40, vocab_size=1024, n_shards=4)
    tok, index = tpipe.prepare_lm_data(str(tmp_path / "port"), **kw)
    assert index.exists()
    ld = tpipe.ShardedLoader(str(tmp_path / "port"), 0, 2, batch=4)
    b = next(iter(ld))
    assert b["tokens"].shape == (4, 33)
    jpipe.prepare_lm_data(str(tmp_path / "ref"), **kw)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 6   # 4 shards, index.json, vocab.json
    for name in names:
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
