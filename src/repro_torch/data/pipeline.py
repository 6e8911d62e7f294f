"""BERT pre-training example builder + data sharding (the BERT half of
``repro/data/pipeline.py``, copied because the reference module imports
JAX through ``repro.models.api``; paper §3.1.1, §4.1).

  * WordPiece-tokenize the raw text,
  * mask 15% of input tokens (80% [MASK] / 10% random / 10% kept, as BERT),
  * build NSP pairs: 50% adjacent sentences, 50% random second segment,
  * pack into fixed (seq_len, n_predictions) examples,
  * **shard before training** (§4.1): the tokenized examples are split into
    one ``.npz`` container per worker; each worker reads ONLY its shard.

The code is the reference's, line for line, so the same seed gives
byte-identical shards (``np.savez`` stamps each member with the clock, so
two writers agree when they write within the same two seconds) and the
loader yields the same batches and cursors.  The causal-LM streams come
with the decoder-training slice.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.tokenizer import (WordPieceTokenizer, synth_corpus,
                                        train_wordpiece)
from repro_torch.models.api import mlm_positions_count


@dataclasses.dataclass
class BertExampleConfig:
    seq_len: int = 128
    n_predictions: int = 20
    mask_prob: float = 0.15
    short_seq_prob: float = 0.1


def build_bert_examples(docs: List[List[List[int]]], tok: WordPieceTokenizer,
                        cfg: BertExampleConfig, seed: int = 0
                        ) -> Dict[str, np.ndarray]:
    """docs: tokenized documents (list of sentences, each a list of ids).

    Returns dense arrays: tokens, type_ids, mlm_positions, mlm_labels,
    nsp_labels  (exactly the train-batch schema in models/api.py).
    """
    rng = np.random.default_rng(seed)
    max_tokens = cfg.seq_len - 3  # [CLS] a [SEP] b [SEP]
    examples = {k: [] for k in ("tokens", "type_ids", "mlm_positions",
                                "mlm_labels", "nsp_labels")}

    flat_sents = [s for d in docs for s in d if s]

    for di, doc in enumerate(docs):
        i = 0
        while i + 1 < len(doc):
            a = doc[i][: max_tokens // 2]
            is_random = rng.random() < 0.5
            if is_random and len(flat_sents) > 2:
                b = flat_sents[rng.integers(len(flat_sents))]
            else:
                is_random = False
                b = doc[i + 1]
            b = b[: max_tokens - len(a)]
            if not a or not b:
                i += 1
                continue

            ids = [tok.cls_id] + a + [tok.sep_id] + b + [tok.sep_id]
            types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
            # --- MLM masking (BERT 80/10/10) ---
            cand = [p for p in range(len(ids))
                    if ids[p] not in (tok.cls_id, tok.sep_id)]
            rng.shuffle(cand)
            n_mask = min(cfg.n_predictions,
                         max(1, int(round(len(cand) * cfg.mask_prob))))
            positions, labels = [], []
            for p in sorted(cand[:n_mask]):
                positions.append(p)
                labels.append(ids[p])
                r = rng.random()
                if r < 0.8:
                    ids[p] = tok.mask_id
                elif r < 0.9:
                    ids[p] = int(rng.integers(SPECIALS_OFFSET, len(tok)))
            # pad
            pad = cfg.seq_len - len(ids)
            ids = ids + [tok.pad_id] * pad
            types = types + [0] * pad
            ppad = cfg.n_predictions - len(positions)
            positions = positions + [0] * ppad
            labels = labels + [-100] * ppad

            examples["tokens"].append(ids)
            examples["type_ids"].append(types)
            examples["mlm_positions"].append(positions)
            examples["mlm_labels"].append(labels)
            examples["nsp_labels"].append(int(is_random))
            i += 2

    return {k: np.asarray(v, dtype=np.int32) for k, v in examples.items()}


SPECIALS_OFFSET = 5  # random-replacement draws avoid special ids


# ---------------------------------------------------------------------------
# Sharding (paper §4.1)
# ---------------------------------------------------------------------------

def write_shards(examples: Dict[str, np.ndarray], out_dir: str,
                 n_shards: int, prefix: str = "shard") -> List[Path]:
    """Exact-cover split of the example arrays into per-worker containers."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(next(iter(examples.values())))
    order = np.arange(n)
    paths = []
    bounds = np.linspace(0, n, n_shards + 1).astype(int)
    for s in range(n_shards):
        sel = order[bounds[s]:bounds[s + 1]]
        path = out / f"{prefix}_{s:05d}.npz"
        np.savez(path, **{k: v[sel] for k, v in examples.items()})
        paths.append(path)
    index = {"n_shards": n_shards, "n_examples": int(n),
             "files": [p.name for p in paths]}
    (out / "index.json").write_text(json.dumps(index, indent=2))
    return paths


def read_shard(path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class ShardedLoader:
    """Per-worker loader: reads ONLY this worker's shard (paper §4.1).

    Yields fixed-size batches with per-epoch reshuffling (cheap because the
    shard is worker-local -- the paper's point: no cross-worker I/O).

    The loader is a *resumable iterator*: its cursor (epoch, within-epoch
    batch offset) round-trips through ``state_dict``/``load_state_dict``,
    and each epoch's permutation is derived from ``(seed, worker, epoch)``
    rather than a mutable RNG stream -- so a loader restored mid-epoch
    continues the EXACT sample sequence of the uninterrupted run (the
    checkpoint-resume contract in train/trainer.py).  ``iter(loader)``
    returns the loader itself; repeated iteration continues, it does not
    restart.
    """

    def __init__(self, shard_dir: str, worker: int, n_workers: int,
                 batch: int, seed: int = 0):
        index = json.loads((Path(shard_dir) / "index.json").read_text())
        assert index["n_shards"] % n_workers == 0 or \
            index["n_shards"] >= n_workers
        files = index["files"][worker::n_workers]
        self.data = None
        for f in files:
            d = read_shard(Path(shard_dir) / f)
            if self.data is None:
                self.data = d
            else:
                self.data = {k: np.concatenate([self.data[k], d[k]])
                             for k in d}
        self.batch = batch
        self.seed, self.worker = seed, worker
        self._n = len(next(iter(self.data.values())))
        if self._n < batch:
            raise ValueError(f"worker {worker}'s shard holds {self._n} "
                             f"examples < batch {batch}")
        self._epoch = 0
        self._offset = 0          # batches already yielded this epoch
        self._order = self._epoch_order(0)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, self.worker, epoch])
        return rng.permutation(self._n)

    @property
    def batches_per_epoch(self) -> int:
        return self._n // self.batch

    def state_dict(self) -> Dict[str, int]:
        """Cursor (epoch, offset) -- everything needed for exact resume;
        the shuffle RNG is implied by (seed, worker, epoch)."""
        return {"epoch": self._epoch, "offset": self._offset,
                "seed": self.seed, "worker": self.worker}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if state.get("seed", self.seed) != self.seed or \
                state.get("worker", self.worker) != self.worker:
            raise ValueError(
                f"loader cursor was saved for seed/worker "
                f"({state.get('seed')}, {state.get('worker')}), this "
                f"loader is ({self.seed}, {self.worker})")
        self._epoch = int(state["epoch"])
        self._offset = int(state["offset"])
        self._order = self._epoch_order(self._epoch)

    def __iter__(self) -> "ShardedLoader":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._offset >= self.batches_per_epoch:
            self._epoch += 1
            self._offset = 0
            self._order = self._epoch_order(self._epoch)
        i = self._offset * self.batch
        sel = self._order[i:i + self.batch]
        self._offset += 1
        return {k: v[sel] for k, v in self.data.items()}


# ---------------------------------------------------------------------------
# End-to-end helpers
# ---------------------------------------------------------------------------

def prepare_bert_data(out_dir: str, *, seq_len: int = 128,
                      n_predictions: Optional[int] = None,
                      n_docs: int = 400, vocab_size: int = 8192,
                      n_shards: int = 8, seed: int = 0):
    """Synthetic corpus -> tokenizer -> examples -> shards.  Returns
    (tokenizer, index_path)."""
    docs_text = synth_corpus(n_docs=n_docs, seed=seed)
    tok = train_wordpiece((s for d in docs_text for s in d),
                          vocab_size=vocab_size)
    docs_ids = [[tok.encode(s) for s in d] for d in docs_text]
    cfg = BertExampleConfig(
        seq_len=seq_len,
        n_predictions=n_predictions or mlm_positions_count(seq_len))
    examples = build_bert_examples(docs_ids, tok, cfg, seed=seed)
    write_shards(examples, out_dir, n_shards)
    tok.save(str(Path(out_dir) / "vocab.json"))
    return tok, Path(out_dir) / "index.json"
