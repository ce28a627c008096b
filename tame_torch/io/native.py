"""ctypes binding + lazy build of the C++ tensor store (``cstore.cpp``, the
port's copy of :mod:`tame.io`'s framework-free store: the same file format
byte for byte, so either package reads the other's files).

The shared library is compiled once with ``g++`` on first use into
``build/tame_torch_io/`` at the repository root (git ignored) and cached
there; the build writes a temporary file and renames it into place, so
concurrent first uses do not load a half-written library.  Without a C++
toolchain the checkpoint layer falls back to numpy ``.npy`` files
(:mod:`tame_torch.io.checkpoint`), and its manifest records which format
was written.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "cstore.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "tame_torch_io"
_LIB = _BUILD / "libtamestore.so"

DTYPE_CODES = {
    np.dtype("float32"): 0,
    np.dtype("float64"): 1,
    np.dtype("int32"): 2,
    np.dtype("int64"): 3,
    np.dtype("uint8"): 4,
}
CODE_DTYPES = {v: k for k, v in DTYPE_CODES.items()}

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return ctypes.CDLL(str(_LIB))
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
                 "-o", tmp], check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, subprocess.SubprocessError):
        _build_failed = True
        return None
    return ctypes.CDLL(str(_LIB))


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first call; None if no
    toolchain is available."""
    global _lib
    if _lib is None and not _build_failed:
        lib = _build()
        if lib is not None:
            lib.tamestore_write.restype = ctypes.c_int64
            lib.tamestore_write.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ctypes.c_int32]
            lib.tamestore_header.restype = ctypes.c_int64
            lib.tamestore_header.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint32)]
            lib.tamestore_read.restype = ctypes.c_int64
            lib.tamestore_read.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
            lib.tamestore_crc32.restype = ctypes.c_uint32
            lib.tamestore_crc32.argtypes = [ctypes.c_void_p,
                                            ctypes.c_int64]
        _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _require_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native tamestore unavailable (no g++)")
    return lib


def write_tensor(path: str | Path, array: np.ndarray) -> None:
    """Write one host array through the native store (CRC32-protected)."""
    lib = _require_lib()
    array = np.asarray(array)
    # ascontiguousarray promotes 0-d to 1-d; restore the original shape.
    array = np.ascontiguousarray(array).reshape(array.shape)
    if array.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {array.dtype}")
    shape = (ctypes.c_int64 * max(array.ndim, 1))(*array.shape)
    rc = lib.tamestore_write(
        str(path).encode(), array.ctypes.data_as(ctypes.c_void_p),
        array.nbytes, shape, array.ndim, DTYPE_CODES[array.dtype])
    if rc != 0:
        raise IOError(f"tamestore_write({path}) failed with code {rc}")


def read_tensor(path: str | Path) -> np.ndarray:
    """Read one array; raises on CRC mismatch or a malformed file."""
    lib = _require_lib()
    shape = (ctypes.c_int64 * 16)()
    ndim = ctypes.c_int32()
    dtype = ctypes.c_int32()
    crc = ctypes.c_uint32()
    nbytes = lib.tamestore_header(str(path).encode(), shape,
                                  ctypes.byref(ndim), ctypes.byref(dtype),
                                  ctypes.byref(crc))
    if nbytes < 0:
        raise IOError(f"tamestore_header({path}) failed with code {nbytes}")
    out = np.empty(tuple(shape[:ndim.value]),
                   dtype=CODE_DTYPES[dtype.value])
    rc = lib.tamestore_read(str(path).encode(),
                            out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise IOError(
            f"tamestore_read({path}) failed with code {rc} "
            f"({'CRC mismatch' if rc == -7 else 'io error'})")
    return out


def crc32(array: np.ndarray) -> int:
    lib = _require_lib()
    array = np.ascontiguousarray(array)
    return int(lib.tamestore_crc32(
        array.ctypes.data_as(ctypes.c_void_p), array.nbytes))
