"""repro_torch — the DoubleR repair data path (arXiv 1704.03696) and dense
serving on PyTorch.

The PyTorch/CUDA counterpart of the ``repro`` package.  Plan-time GF(256)
linear algebra (generators, repair plans, SPMD schedules) is numpy, a copy
of the reference's; payload bytes live on the device as ``torch.uint8`` and
go through the hand-written CUDA GF kernel in ``repro_torch.kernels``.  The
dense models (``models``, ``configs``) serve through ``serve``, whose
prefill runs the hand-written CUDA flash-attention kernel.

This package imports neither ``jax`` nor anything of ``repro``.
"""
