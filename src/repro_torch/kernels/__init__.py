"""Hand-written CUDA kernels of the port, their builds and launch wrappers."""
