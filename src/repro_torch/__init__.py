"""PyTorch/CUDA port of the serving path of ``repro``.

The JAX package (``repro``) is the reference. This package imports torch and
numpy, never jax and nothing of ``repro``: it keeps its own copies of the
numpy-only modules it needs (configs, locality sets, Eq.-1 paging). Module
names follow the reference's, so each counterpart is easy to find.

Its kernels (flash and paged attention, the GLA scan of RWKV6) are CUDA C++
for Hopper (``csrc/*.cu``), built with ``nvcc`` at first use by
``kernels/_build.py``.
"""
__version__ = "0.1.0"
