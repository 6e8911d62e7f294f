"""Training (port of ``repro/train``): the step and the two-phase BERT
schedule.  The fault-tolerant runtime (checkpoints, the supervised loop,
fault injection) ports with a later slice."""
