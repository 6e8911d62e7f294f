"""WordPiece-style tokenizer (paper §3.1.1, ref [35]); a copy of
``repro/data/tokenizer.py``, which the port may not import.

Wikipedia/BookCorpus are not available offline, so the *pipeline* is built
faithfully over a deterministic synthetic corpus: a Zipfian unigram language
with sentence/document structure.  The tokenizer is a greedy
longest-match-first subword tokenizer trained by frequency (the WordPiece
inference algorithm; training is simplified from likelihood to frequency,
which preserves every property the systems paper relies on).
"""
from __future__ import annotations

import collections
import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]


@dataclasses.dataclass
class WordPieceTokenizer:
    vocab: Dict[str, int]
    max_word_len: int = 32

    @property
    def pad_id(self):
        return self.vocab[PAD]

    @property
    def unk_id(self):
        return self.vocab[UNK]

    @property
    def cls_id(self):
        return self.vocab[CLS]

    @property
    def sep_id(self):
        return self.vocab[SEP]

    @property
    def mask_id(self):
        return self.vocab[MASK]

    def __len__(self):
        return len(self.vocab)

    def tokenize_word(self, word: str) -> List[int]:
        """Greedy longest-match-first WordPiece."""
        if len(word) > self.max_word_len:
            return [self.unk_id]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            out.append(cur)
            start = end
        return out

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in text.strip().split():
            ids.extend(self.tokenize_word(word))
        return ids

    def save(self, path: str):
        Path(path).write_text(json.dumps(self.vocab))

    @classmethod
    def load(cls, path: str) -> "WordPieceTokenizer":
        return cls(vocab=json.loads(Path(path).read_text()))


def train_wordpiece(corpus: Iterable[str], vocab_size: int = 8192,
                    min_freq: int = 2) -> WordPieceTokenizer:
    """Frequency-based WordPiece training: chars + frequent substrings."""
    word_freq = collections.Counter()
    for line in corpus:
        word_freq.update(line.strip().split())

    sub_freq = collections.Counter()
    for word, f in word_freq.items():
        n = len(word)
        for i in range(n):
            for j in range(i + 1, min(i + 12, n) + 1):
                piece = word[i:j] if i == 0 else "##" + word[i:j]
                sub_freq[piece] += f

    vocab = {tok: i for i, tok in enumerate(SPECIALS)}
    # all single chars first (guarantees coverage), then by frequency
    singles = {p for p in sub_freq if len(p.lstrip("#")) == 1 or
               (p.startswith("##") and len(p) == 3)}
    for p in sorted(singles):
        if p not in vocab:
            vocab[p] = len(vocab)
    for p, f in sub_freq.most_common():
        if len(vocab) >= vocab_size:
            break
        if f >= min_freq and p not in vocab:
            vocab[p] = len(vocab)
    return WordPieceTokenizer(vocab=vocab)


# ---------------------------------------------------------------------------
# Synthetic corpus (deterministic stand-in for Wikipedia+BookCorpus)
# ---------------------------------------------------------------------------

_SYLLABLES = ["ba", "be", "bi", "bo", "bu", "da", "de", "di", "do", "du",
              "ka", "ke", "ki", "ko", "ku", "la", "le", "li", "lo", "lu",
              "ma", "me", "mi", "mo", "mu", "na", "ne", "ni", "no", "nu",
              "ra", "re", "ri", "ro", "ru", "sa", "se", "si", "so", "su",
              "ta", "te", "ti", "to", "tu", "za", "ze", "zi", "zo", "zu"]


def synth_corpus(n_docs: int = 200, seed: int = 0,
                 sentences_per_doc: tuple = (4, 12),
                 words_per_sentence: tuple = (4, 16),
                 vocab_words: int = 2000) -> List[List[str]]:
    """Deterministic Zipfian corpus: list of documents (lists of sentences)."""
    rng = np.random.default_rng(seed)
    # build word list
    words = []
    for i in range(vocab_words):
        n_syll = 1 + int(rng.integers(1, 4))
        words.append("".join(rng.choice(_SYLLABLES) for _ in range(n_syll)))
    ranks = np.arange(1, vocab_words + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()

    docs = []
    for d in range(n_docs):
        n_sent = int(rng.integers(*sentences_per_doc))
        sents = []
        for s in range(n_sent):
            n_words = int(rng.integers(*words_per_sentence))
            idx = rng.choice(vocab_words, size=n_words, p=probs)
            sents.append(" ".join(words[i] for i in idx))
        docs.append(sents)
    return docs
