"""Host C++ code of the port, built with g++ at first use (``build.py``).

ref mpreid_tpu/native/. ``imageio``: the OpenMP batch JPEG / PNG decoder
with a Pillow-exact bicubic resize, behind ``DATALOADER.NATIVE_DECODE``.
``rerank``: the OpenMP k-reciprocal re-ranker on the host's cores.
"""

from .imageio import decode_resize_batch_native, native_imageio_available, resize_rgb8_native
from .rerank import native_available, re_ranking_native

__all__ = [
    "native_available",
    "re_ranking_native",
    "native_imageio_available",
    "decode_resize_batch_native",
    "resize_rgb8_native",
]
