"""Hand-written CUDA kernels of the port (sources in ``csrc/``) with their
plain PyTorch versions and wrappers."""
