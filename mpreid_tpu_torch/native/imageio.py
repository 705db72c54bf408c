"""ctypes wrapper of the native batch image decoder (``imageio.cpp``).

ref mpreid_tpu/native/imageio.py. One C call decodes (libjpeg / libpng) and
bicubically resizes a whole batch under OpenMP: the native counterpart of
``data/loader.py::decode_resize``, which ``ImageBatcher`` takes under
``DATALOADER.NATIVE_DECODE``.

``native_imageio_available()`` is True only when the library builds
(``native/build.py``: g++, OpenMP, the libjpeg and libpng headers) and a
self-check passes: an in-memory image resized by the library and by Pillow,
then a JPEG and a PNG that Pillow wrote, decoded and resized by both, must
match byte for byte. A host libjpeg that decodes otherwise than Pillow's
bundled one fails the check, and the native path stays off
(``why_unavailable()`` says why). Pillow is imported only inside the check.

Failed rows of a batch are zeroed and flagged in a status vector; the
caller decodes those images with Pillow (``data/loader.py`` does).
"""

from __future__ import annotations

import ctypes
import os
import tempfile
from typing import List, Tuple

import numpy as np

from .build import NativeLibrary

_U8 = ctypes.POINTER(ctypes.c_ubyte)
_I32 = ctypes.POINTER(ctypes.c_int)


def _declare(lib: ctypes.CDLL) -> None:
    lib.decode_resize_batch.restype = ctypes.c_int
    lib.decode_resize_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, _U8, _I32]
    lib.pil_resize_rgb8.restype = ctypes.c_int
    lib.pil_resize_rgb8.argtypes = [_U8, ctypes.c_int, ctypes.c_int, _U8, ctypes.c_int,
                                    ctypes.c_int]


def _resize(lib, img: np.ndarray, out_h: int, out_w: int) -> Tuple[np.ndarray, int]:
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.pil_resize_rgb8(img.ctypes.data_as(_U8), img.shape[0], img.shape[1],
                             out.ctypes.data_as(_U8), out_h, out_w)
    return out, rc


def _decode_batch(lib, paths: List[str], size_hw) -> Tuple[np.ndarray, np.ndarray]:
    h, w = size_hw
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    status = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.decode_resize_batch(names, n, h, w, out.ctypes.data_as(_U8), status.ctypes.data_as(_I32))
    return out, status


def _self_check(lib: ctypes.CDLL) -> str:
    """"" when the library's resize and codecs match Pillow byte for byte,
    else what differed (ref ``_self_check``: the same images and sizes)."""
    try:
        from PIL import Image
    except ImportError:
        return "Pillow is not installed (the self-check needs it)"
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (37, 23, 3), dtype=np.uint8)
    out_h, out_w = 24, 12
    pil = np.asarray(Image.fromarray(img).resize((out_w, out_h), Image.BICUBIC), np.uint8)
    got, rc = _resize(lib, img, out_h, out_w)
    if rc != 0 or not np.array_equal(got, pil):
        return f"the resize differs from Pillow's BICUBIC (rc {rc})"

    # the codecs: both sides decode the same lossy file, so a decoder that
    # differs shows as a byte mismatch
    yy, xx = np.mgrid[0:37, 0:23]
    smooth = np.stack([(yy * 5) % 256, (xx * 9) % 256, (yy + xx) * 3 % 256],
                      axis=-1).astype(np.uint8)
    with tempfile.TemporaryDirectory(prefix="mpreid_imageio_check_") as tmp:
        paths = []
        for ext in ("jpg", "png"):
            p = os.path.join(tmp, f"check.{ext}")
            Image.fromarray(smooth).save(p)
            paths.append(p)
        out, status = _decode_batch(lib, paths, (out_h, out_w))
        if np.any(status != 0):
            return f"the codecs failed on Pillow's files (status {status.tolist()})"
        for i, p in enumerate(paths):
            with Image.open(p) as im:
                ref = np.asarray(im.convert("RGB").resize((out_w, out_h), Image.BICUBIC),
                                 np.uint8)
            if not np.array_equal(out[i], ref):
                return (f"the host's {'libjpeg' if p.endswith('jpg') else 'libpng'} decodes "
                        f"otherwise than Pillow")
    return ""


LIBRARY = NativeLibrary("imageio", libs=("-ljpeg", "-lpng"), declare=_declare,
                        check=_self_check)


def native_imageio_available() -> bool:
    return LIBRARY.get() is not None


def why_unavailable() -> str:
    """Why the native decoder is off ("" when it is available)."""
    LIBRARY.get()
    return LIBRARY.why


def _lib():
    lib = LIBRARY.get()
    if lib is None:
        raise RuntimeError(f"native imageio unavailable: {LIBRARY.why}")
    return lib


def resize_rgb8_native(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pillow-exact bicubic resize of one (H, W, 3) uint8 array."""
    out, rc = _resize(_lib(), img, out_h, out_w)
    if rc != 0:
        raise RuntimeError(f"native resize failed ({rc})")
    return out


def decode_resize_batch_native(paths: List[str], size_hw: Tuple[int, int]
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """→ ((N, H, W, 3) uint8 batch, (N,) int32 status; 0 = ok).

    Failed rows are zeroed: the caller decides whether to decode them with
    Pillow (``data/loader.py`` does, per image)."""
    return _decode_batch(_lib(), paths, size_hw)
