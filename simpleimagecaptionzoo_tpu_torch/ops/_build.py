"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
with ``nvcc`` alone (no PyTorch headers), into
``build/lib<name>-<hash>.so``; the hash covers the source, the shared
headers and the flags, so an edited source never meets a stale library.
nvcc's output, with ptxas's registers, shared memory and spills of every
kernel (``-Xptxas -v``), is kept beside it as ``<library>.log``.
The library is loaded with ``ctypes``.  Every C entry point takes its
pointers and the CUDA stream as ``void*`` and returns ``cudaGetLastError()``
after its launches; :func:`check` raises on a nonzero code.

A failed build raises, with nvcc's output.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


class Counter:
    """Launch count of one kernel: its wrapper adds one per launch."""

    def __init__(self) -> None:
        self.n = 0


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "simpleimagecaptionzoo_tpu_torch are built with it")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:12]))


def _command(name: str, out: str) -> list:
    return ([nvcc_path()] + NVCC_FLAGS + ["-I", CSRC_DIR, "-o", out,
                                          os.path.join(CSRC_DIR, name + ".cu")])


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc`` per
    source, all started together.  Returns {name: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = "%s.%d.tmp" % (path, os.getpid())
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode,
                                                      out))
            continue
        with open(paths[name] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed;
    ``declare`` sets the argtypes and restype of its entry points."""
    if name not in _LIBS:
        lib = ctypes.CDLL(build([name])[name])
        declare(lib)
        _LIBS[name] = lib
    return _LIBS[name]


def tma_aligned(*ts) -> bool:
    """True when every tensor starts on a 16-byte boundary and every row
    stride is a multiple of 16 bytes: what a TMA tensor map needs."""
    return all(t.data_ptr() % 16 == 0 and all(
        (st * t.element_size()) % 16 == 0 for st in t.stride()[:-1])
        for t in ts)


# the codes the C entries return for arguments they refuse
_ERRORS = {1: "invalid value", 716: "misaligned address"}


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError("%s: CUDA error %d (%s) at launch" % (
            what, code, _ERRORS.get(code, "see cudaError_t")))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
