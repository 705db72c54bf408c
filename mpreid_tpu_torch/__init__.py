"""PyTorch + CUDA port of mpreid_tpu for NVIDIA Hopper.

The package mirrors ``mpreid_tpu/`` module for module and is held against
it by ``tests/test_torch_*.py``; it imports ``torch`` and nothing of JAX or
of the JAX package. Its kernels are hand-written for ``sm_90a``
(``kernels/csrc``). Entry points: ``python -m mpreid_tpu_torch.train`` and
``python -m mpreid_tpu_torch.test``.
"""
