"""PyTorch + CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The module layout mirrors ``src/repro/`` so the counterpart of every file is
found under the same name.  This package imports neither ``jax`` nor
anything from ``repro``: it keeps its own copies of what it needs (see
``repro_torch.configs``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel.

Ported so far (slice 1, decoder-LM serving): configs, the AMP policy, the
flash-attention forward and paged-decode kernels, the dense decoder layers
and transformer, the continuous-batching scheduler and its CLI.
"""
