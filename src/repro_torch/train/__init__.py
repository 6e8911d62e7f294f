"""Training (port of ``repro/train``): the step, the two-phase BERT
schedule and the fault-tolerant runtime -- atomic checkpoints
(``checkpoint``), fault injection (``faults``) and the supervised loop
(``trainer``)."""
