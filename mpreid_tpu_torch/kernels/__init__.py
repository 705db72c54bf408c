"""Hand-written Hopper kernels: CUDA C++ sources under ``csrc/``, built by
``build.py`` at first use. The Python wrappers live beside the plain
versions they replace (ops/attention.py)."""
