"""ctypes bindings for the native threaded depth-frame loader.

Port of dynfu_tpu/io/native_loader.py. The native side is the repo's
native/dynfu_loader.cpp, unchanged: a libpng decoder behind a worker pool
that keeps decoded frames ahead of the consumer, so host-side decode
overlaps device work. It is built at first use with g++ into
build/native/libdynfu_loader.so of the checkout. Where it cannot be built
(no compiler, no libpng headers, no native/ source beside the package)
or loaded (no libpng), DepthLoader decodes with io/meshio's codec instead; both give the same
arrays for the 8- and 16-bit greyscale PNGs of a depth dataset.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np

from dynfu_tpu_torch.io import meshio

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "dynfu_loader.cpp"
_LIB = _ROOT / "build" / "native" / "libdynfu_loader.so"


def _find_or_build_lib() -> Optional[Path]:
    """The library, built when missing or older than its source; None when
    it cannot be built. The build writes a temporary file and renames it,
    so concurrent first uses never load a half-written library."""
    if not _SRC.exists():
        return None
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_LIB.parent, suffix=".so")
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", str(_SRC),
             "-o", tmp, "-lpng", "-lz", "-lpthread"],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return _LIB
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = _find_or_build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:  # built elsewhere: libpng itself may be missing here
        return None
    lib.dfl_open.restype = ctypes.c_void_p
    lib.dfl_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.dfl_get.restype = ctypes.c_int
    lib.dfl_get.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_size_t,
    ]
    lib.dfl_size.restype = ctypes.c_size_t
    lib.dfl_size.argtypes = [ctypes.c_void_p]
    lib.dfl_close.restype = None
    lib.dfl_close.argtypes = [ctypes.c_void_p]
    lib.dfl_decode_one.restype = ctypes.c_int
    lib.dfl_decode_one.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_size_t,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


_MAX_PIXELS = 4096 * 4096


class DepthLoader:
    """Iterates decoded (H, W) int32 mm depth frames with native prefetch.

    Frames must be consumed roughly IN ORDER (the prefetch ring holds
    `queue_depth` decoded frames; seeking far backwards blocks). Decodes
    synchronously with io/meshio's codec when the native library cannot be
    built, or when a path is not a PNG (libpng reads PNGs only); `native`
    says which decoder runs."""

    def __init__(self, paths: List[str], queue_depth: int = 8,
                 threads: int = 4):
        self.paths = list(paths)
        self._lib = None
        self._handle = None
        if self.paths and all(p.lower().endswith(".png") for p in self.paths):
            self._lib = _load()
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.dfl_open(arr, len(self.paths),
                                              queue_depth, threads)
            self._buf = np.empty((_MAX_PIXELS,), np.uint16)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self.paths):
            raise IndexError(i)
        if self._handle is None:
            return meshio.load_depth_png(self.paths[i])
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.dfl_get(
            self._handle, i,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ctypes.byref(h), ctypes.byref(w), self._buf.size,
        )
        if rc != 0:
            raise IOError(f"native decode of {self.paths[i]!r} failed "
                          f"(rc={rc})")
        return (self._buf[: h.value * w.value]
                .reshape(h.value, w.value).astype(np.int32))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._handle is not None:
            self._lib.dfl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
