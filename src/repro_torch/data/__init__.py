"""BERT pretraining data (numpy-only copies of ``repro/data``): the
WordPiece tokenizer, the synthetic corpus, example building, sharding and
the resumable per-worker loader."""
