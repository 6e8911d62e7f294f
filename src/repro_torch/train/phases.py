"""Two-phase BERT pretraining schedule (copy of ``repro/train/phases.py``;
paper §3.3, Table 6).

Phase 1: seq 128, 20 predictions, 90% of steps (paper: 36/40 epochs).
Phase 2: seq 512, 80 predictions, 10% of steps (paper: 4/40 epochs).
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs.base import InputShape


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    seq_len: int
    n_predictions: int
    global_batch: int          # paper Table 6: 4096 / 2048 sentences
    steps: int
    learning_rate: float = 1e-4

    @property
    def shape(self) -> InputShape:
        return InputShape(self.name, self.seq_len, self.global_batch,
                          "train")


def bert_phases(total_steps: int, *, global_batch_p1: int = 4096,
                global_batch_p2: int = 2048, scale_batch: float = 1.0
                ) -> List[Phase]:
    b1 = max(8, int(global_batch_p1 * scale_batch))
    b2 = max(8, int(global_batch_p2 * scale_batch))
    p1 = int(round(total_steps * 0.9))
    return [
        Phase("phase1", 128, 20, b1, p1, 1e-4),
        Phase("phase2", 512, 80, b2, total_steps - p1, 1e-4),
    ]
