"""ctypes binding for the native JPEG decode+resize (native/image_loader.cpp).

The host input pipeline's hot path — JPEG -> RGB -> Pillow-parity bilinear
resize — runs in C++ when ``native/build/libsicz_image.so`` is built
(``make -C native``).  The C call releases the GIL, so the data layer's
decode thread pool scales across cores instead of contending on Python.

Every entry returns ``None`` when the library is absent or an image is
unsupported (CMYK, corrupt, non-JPEG) — callers fall back to PIL, which is
also the semantic reference: ``sicz_resize_rgb8`` is byte-identical to
``PIL.Image.resize(..., BILINEAR)`` (tests/test_native_image.py), and the
decode matches PIL's up to libjpeg-version IDCT differences (<=1/255 per
pixel).  Set ``SICZ_TPU_NO_NATIVE=1`` to disable.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SICZ_TPU_NO_NATIVE"):
        return None
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "native", "build", "libsicz_image.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sicz_decode_jpeg_resize.argtypes = [u8p, ctypes.c_int,
                                                ctypes.c_int, u8p]
        lib.sicz_decode_jpeg_resize.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.sicz_decode_jpeg_resize_fast.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        lib.sicz_decode_jpeg_resize_fast.restype = ctypes.c_int
        lib.sicz_decode_jpeg_scaled.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ip, ip]
        lib.sicz_decode_jpeg_scaled.restype = ctypes.c_int
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _lib() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_jpeg_resize_bytes(data: bytes, size: int) -> Optional[np.ndarray]:
    """In-memory JPEG stream -> (size, size, 3) uint8, or None to fall back
    to PIL (library absent, not a JPEG, or unsupported/corrupt stream).
    Used by the serving surface, whose images arrive as upload bytes."""
    lib = _lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    if buf.size < 2 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None                                  # not a JPEG stream
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.sicz_decode_jpeg_resize(_u8p(buf), int(buf.size), int(size),
                                     _u8p(out))
    return out if rc == 0 else None


def decode_jpeg_resize(path: str, size: int) -> Optional[np.ndarray]:
    """JPEG file -> (size, size, 3) uint8, or None to fall back to PIL."""
    if _lib() is None:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_jpeg_resize_bytes(data, size)


def decode_jpeg_resize_fast(path: str, size: int,
                            fast_dct: bool = False) -> Optional[np.ndarray]:
    """FAST-mode JPEG file -> (size, size, 3) uint8: DCT-domain scaled
    decode (1/2..1/8, min-dim kept >= size) + Pillow-semantics resample
    from the smaller image.  ~3-4x less host work than the parity path;
    pixels differ slightly from the full-res PIL transform.  None -> PIL
    fallback."""
    lib = _lib()
    if lib is None:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    buf = np.frombuffer(data, np.uint8)
    if buf.size < 2 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.sicz_decode_jpeg_resize_fast(_u8p(buf), int(buf.size),
                                          int(size), int(bool(fast_dct)),
                                          _u8p(out))
    return out if rc == 0 else None


def decode_jpeg_scaled(data: bytes, min_size: int, pad: int,
                       fast_dct: bool = False):
    """FASTEST-mode JPEG bytes -> (padded (pad, pad, 3) uint8, h, w): the
    DCT-scaled decode lands top-left in the pad box, NO host resample —
    the device triangle-resample kernel (ops/image.resize_normalize)
    finishes the job fused ahead of normalization.  The box is NOT zeroed:
    the kernel's weights are exactly 0 beyond (h, w), so the pad region is
    provably dead (tests/test_ingest_fast.py garbage-leak test).  None ->
    caller takes the host-resize path (library absent, non-JPEG,
    unsupported, or the scaled decode can't fit the pad box)."""
    lib = _lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    if buf.size < 2 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    out = np.empty((pad, pad, 3), np.uint8)
    h = ctypes.c_int(0)
    w = ctypes.c_int(0)
    rc = lib.sicz_decode_jpeg_scaled(_u8p(buf), int(buf.size),
                                     int(min_size), int(pad),
                                     int(bool(fast_dct)), _u8p(out),
                                     ctypes.byref(h), ctypes.byref(w))
    return (out, h.value, w.value) if rc == 0 else None
