"""ctypes binding for the native (C++) runtime components in ``native/``.

Loads ``native/build/libsicz_native.so`` if it has been built (``make -C
native``); every caller has a pure-Python fallback, so the library is an
accelerator, never a requirement.  Set ``SICZ_TPU_NO_NATIVE=1`` to disable.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional

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
    path = os.path.join(root, "native", "build", "libsicz_native.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.sicz_ptb_tokenize_lines.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.sicz_ptb_tokenize_lines.restype = ctypes.c_void_p
        lib.sicz_free.argtypes = [ctypes.c_void_p]
        lib.sicz_free.restype = None
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _lib() is not None


def ptb_tokenize_lines(lines: List[str], n_threads: int = 0) -> Optional[List[str]]:
    """Tokenize caption lines natively; None if the library isn't built or
    the input can't round-trip through UTF-8.

    Non-ASCII lines are routed to the pure-Python tokenizer: the C++ path
    lowercases/splits byte-wise, which matches Python's Unicode-aware
    ``str.lower()``/``str.split()`` only on ASCII — an accented word or a
    non-breaking space would tokenize differently depending on whether the
    native library is built, silently machine-dependent.  Captions are
    overwhelmingly ASCII, so the native speedup is preserved."""
    lib = _lib()
    if lib is None:
        return None
    text = "\n".join(line.replace("\n", " ") for line in lines)
    try:
        raw = text.encode("utf-8")
    except UnicodeEncodeError:
        return None
    ptr = lib.sicz_ptb_tokenize_lines(raw, n_threads)
    try:
        out = ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.sicz_free(ptr)
    out = out.split("\n")
    non_ascii = [i for i, line in enumerate(lines) if not line.isascii()]
    if non_ascii and len(out) == len(lines):
        from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import (
            tokenize_caption)
        for i in non_ascii:
            out[i] = tokenize_caption(lines[i])
    return out
