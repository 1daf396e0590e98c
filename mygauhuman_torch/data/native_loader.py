"""ctypes binding for the native C++ decode/prefetch pipeline (port of
data/native_loader.py).

Builds the unchanged `native/dataloader.cpp` on first use (g++, libjpeg,
libpng) into `build/torch_native/libdataloader.so`, a path of the port's
own: the JAX package builds the same source into `build/`, and a build
here is written under a temporary name and renamed into place, so neither
package nor parallel test processes ever load a half-written library.
Exposes:
  * decode_image(path, half_scale)        — one-shot decode -> float32 HWC
  * NativeImageLoader(workers, capacity)  — threaded submit/collect pipeline
Falls back to imageio (host decode) when the toolchain or libraries are
unavailable (`native_available()` reports which path is active).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "dataloader.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
_SO = os.path.join(_BUILD_DIR, "libdataloader.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC,
             "-ljpeg", "-lpng", "-lz", "-lpthread"],
            check=True, capture_output=True,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = str(e)
            return None

        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dl_submit.restype = ctypes.c_int
        lib.dl_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long, ctypes.c_int]
        lib.dl_wait.restype = ctypes.c_long
        lib.dl_wait.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dl_release.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        lib.dl_decode_file.restype = ctypes.c_int
        lib.dl_decode_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dl_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def decode_image(path: str, half_scale: bool = False) -> np.ndarray:
    """Decode one image -> float32 [H, W, C] in [0, 1]."""
    lib = _load()
    if lib is None:
        import imageio.v2 as imageio

        img = imageio.imread(path).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        if half_scale:
            img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                          + img[0::2, 1::2] + img[1::2, 1::2])
        return img

    data = ctypes.POINTER(ctypes.c_float)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.dl_decode_file(path.encode(), int(half_scale),
                            ctypes.byref(data), ctypes.byref(h),
                            ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        raise IOError(f"native decode failed for {path}")
    arr = np.ctypeslib.as_array(data, shape=(h.value, w.value, c.value)).copy()
    lib.dl_free(data)
    return arr


class NativeImageLoader:
    """Threaded decode pipeline: submit paths, collect float32 arrays.

    with NativeImageLoader(workers=8) as dl:
        for i, p in enumerate(paths):
            dl.submit(p, i, half_scale=True)
        for _ in paths:
            job_id, img = dl.collect()
    """

    def __init__(self, workers: int = 8, capacity: int = 32):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"native loader unavailable: {_build_error}"
            )
        self._lib = lib
        self._h = lib.dl_create(workers, capacity)

    def submit(self, path: str, job_id: int, half_scale: bool = False):
        self._lib.dl_submit(self._h, path.encode(), job_id, int(half_scale))

    def collect(self) -> tuple[int, np.ndarray]:
        data = ctypes.POINTER(ctypes.c_float)()
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        job_id = self._lib.dl_wait(self._h, ctypes.byref(data),
                                   ctypes.byref(h), ctypes.byref(w),
                                   ctypes.byref(c))
        if job_id < 0:
            real_id = -job_id - 1
            self._lib.dl_release(self._h, real_id)
            raise IOError(f"decode failed for job {real_id}")
        arr = np.ctypeslib.as_array(
            data, shape=(h.value, w.value, c.value)
        ).copy()
        self._lib.dl_release(self._h, job_id)
        return int(job_id), arr

    def load_all(self, paths: list, half_scale: bool = False) -> list:
        """Decode a path list in parallel, order-preserving."""
        for i, p in enumerate(paths):
            self.submit(p, i, half_scale)
        out: list = [None] * len(paths)
        for _ in paths:
            i, img = self.collect()
            out[i] = img
        return out

    def close(self):
        if self._h is not None:
            self._lib.dl_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
