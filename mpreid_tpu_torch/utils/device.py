"""Device resolution for the port's entry points.

ref mpreid_tpu/utils/platform.py::apply_device. The JAX package picks an
XLA platform; the port picks a ``torch.device``. ``MODEL.DEVICE`` values
``tpu``, ``gpu`` and ``cuda`` all mean the CUDA card (``tpu`` is the shared
config default); ``cpu`` asks for the CPU. Without a card the port raises
rather than run on the CPU unasked. There is no compile cache to set up:
PyTorch runs eagerly.
"""

from __future__ import annotations

import torch

_CARD_NAMES = ("tpu", "gpu", "cuda")


def resolve_device(name) -> torch.device:
    """``MODEL.DEVICE`` (or a device string) → an explicit ``torch.device``."""
    device = str(name).strip().lower()
    if device == "cpu":
        return torch.device("cpu")
    if device in _CARD_NAMES or device.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} asks for the CUDA card, but none is available; "
                "pass MODEL.DEVICE cpu to run on the CPU"
            )
        return torch.device(device if device.startswith("cuda:") else "cuda")
    raise ValueError(
        f"unknown device {name!r}; expected 'cpu' or one of {_CARD_NAMES}"
    )


def device_from_cfg(cfg) -> torch.device:
    """``MODEL.DEVICE`` of ``cfg``. With ``TPU.COMPUTE_DTYPE float32`` on the
    card it also turns off cuDNN's TF32 (``torch.backends.cudnn.allow_tf32``,
    which PyTorch leaves on for convolutions though not for matrix
    products), so the RN50 tower's fp32 convolutions stay fp32; bf16 runs
    are not affected."""
    device = resolve_device(cfg.MODEL.DEVICE)
    if device.type == "cuda" and cfg.TPU.COMPUTE_DTYPE == "float32":
        torch.backends.cudnn.allow_tf32 = False
    return device
