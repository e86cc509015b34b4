"""ctypes bindings for the native (C++) TIFF decoder, built at first use.

Counterpart of superresolution_tpu/data/native_io.py over the port's own
copy of the decoder (superresolution_tpu_torch/native/loader.cpp). g++
compiles it at first use into superresolution_tpu_torch/_build/, under a
name keyed by a hash of the source and flags (written to a temporary
file and renamed, so concurrent builders do not collide), never next to
the source. As in the reference, a missing toolchain or an undecodable
file gives None and the caller falls back to PIL (data/io.py).

`decode_batch` is the Loader's fast path: N files in one native call
across a thread pool. `decode_batch.batches` counts the batches it
served (a run can check that the native path was taken).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path | None:
    """The shared library for the current source, compiled if absent;
    None when g++ fails or is missing."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    so = BUILD_DIR / f"libsrloader_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, subprocess.SubprocessError):
        return None
    return so


def get_lib():
    """The loaded decoder, or None when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.srloader_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.srloader_decode.restype = ctypes.c_int
        lib.srloader_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.srloader_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def decode_tiff(path: str, max_hw: int = 4096) -> np.ndarray | None:
    """Decode one grayscale TIFF natively -> HWC float32 [0,1], or None."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(max_hw * max_hw, np.float32)
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    rc = lib.srloader_decode(path.encode(), _fptr(buf), buf.size,
                             ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value, 1).copy()


def decode_batch(paths: list[str], hw: tuple[int, int],
                 num_threads: int = 4) -> np.ndarray | None:
    """Decode a batch of same-size grayscale TIFFs -> [N,H,W,1] float32,
    or None if any file fails or the native path is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    h, w = hw
    out = np.empty((n, h * w), np.float32)
    hs = np.empty(n, np.int64)
    ws = np.empty(n, np.int64)
    status = np.empty(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.srloader_decode_batch(
        arr, n, _fptr(out), h * w, _iptr(hs), _iptr(ws),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    if (status != 0).any() or (hs != h).any() or (ws != w).any():
        return None
    decode_batch.batches += 1
    return out.reshape(n, h, w, 1)


decode_batch.batches = 0
