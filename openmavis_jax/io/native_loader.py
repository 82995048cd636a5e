"""ctypes bindings for the native C++ dataset runtime (native/loader.cpp).

The shared library is not committed: `native/Makefile` builds it from
`native/loader.cpp` on first use (needs g++ and libpng). Callers treat an
unavailable native loader as "use PIL".
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO = os.path.join(_NATIVE_DIR, "libomv_loader.so")

_lib = None


def _build():
    """Build the library once; concurrent processes (test workers) wait on
    a lock so none loads a half-written file."""
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_SO):
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.omv_png_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int]
    lib.omv_png_decode_gray.restype = ctypes.c_int
    lib.omv_png_info.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.omv_png_info.restype = ctypes.c_int
    lib.omv_stream_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.omv_stream_open.restype = ctypes.c_void_p
    lib.omv_stream_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_ubyte)]
    lib.omv_stream_next.restype = ctypes.c_int
    lib.omv_stream_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeDecoder:
    """Single-image decode interface (datasets.load_gray plugin)."""

    def __init__(self):
        self.lib = get_lib()
        self._shape_cache = {}

    def decode(self, path: str):
        lib = self.lib
        w = ctypes.c_int()
        h = ctypes.c_int()
        if lib.omv_png_info(path.encode(), ctypes.byref(w),
                            ctypes.byref(h)) != 0:
            return None
        buf = np.empty((h.value, w.value), np.uint8)
        rc = lib.omv_png_decode_gray(
            path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            w.value, h.value)
        if rc != 0:
            return None
        return buf.astype(np.float32)


class FrameStream:
    """Ordered multi-threaded prefetch over a list of image paths."""

    def __init__(self, paths, width: int, height: int,
                 n_threads: int = 4, capacity: int = 8):
        self.lib = get_lib()
        self.w, self.h = width, height
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._paths_keepalive = arr
        self.handle = self.lib.omv_stream_open(
            arr, len(paths), width, height, n_threads, capacity)
        self.n = len(paths)

    def __iter__(self):
        return self

    def __next__(self):
        buf = np.empty((self.h, self.w), np.uint8)
        rc = self.lib.omv_stream_next(
            self.handle, buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_ubyte)))
        if rc == -1:
            raise StopIteration
        if rc == -2:
            raise IOError("native decode failed")
        return buf.astype(np.float32)

    def close(self):
        if self.handle:
            self.lib.omv_stream_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
