"""The benchmark of mpreid_tpu_torch (the PyTorch and CUDA port): see README.md."""
