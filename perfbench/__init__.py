"""Benchmark of the PyTorch and CUDA port, ``repro_torch``: DoubleR node
recovery, degraded reads and stripe writes.  ``python3 perfbench/run.py``
runs one cell; ``BENCHMARK.json`` at the root lists the cells."""
