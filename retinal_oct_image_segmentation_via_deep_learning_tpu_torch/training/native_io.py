"""ctypes bindings for the repository's native C++ IO runtime
(``native/octseg_io.cc``; the JAX package's ``training/native_io.py``).

A MetaImage volume reader with zlib, a threaded prefetch pool that reads
and decompresses volumes ahead of the consumer, and an in-place per-image
z-score. The first use compiles the source with ``g++`` into the package's
``_build/`` directory, under a name hashed from the source and the flags;
later uses and later processes load that library. A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DTYPES = (np.uint8, np.int8, np.uint16, np.int16, np.int32, np.uint32,
           np.float32, np.float64)

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "octseg_io.cc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lz", "-lpthread"]

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"liboctseg_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/octseg_io.cc`` unless a library for this source
    exists; raise with g++'s output if it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {SRC}: {e}") from e
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({done.returncode}):\n"
                           f"{' '.join(cmd)}\n{done.stdout}\n{done.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.octseg_mhd_info.restype = ctypes.c_int
        lib.octseg_mhd_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.octseg_mhd_read.restype = ctypes.c_int
        lib.octseg_mhd_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.octseg_prefetch_create.restype = ctypes.c_void_p
        lib.octseg_prefetch_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.octseg_prefetch_next.restype = ctypes.c_int
        lib.octseg_prefetch_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.octseg_prefetch_destroy.restype = None
        lib.octseg_prefetch_destroy.argtypes = [ctypes.c_void_p]
        lib.octseg_zscore.restype = None
        lib.octseg_zscore.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        _lib = lib
        return lib


def mhd_info(path: str):
    """-> (dims (X, Y, Z), numpy dtype, compressed flag)."""
    lib = get_lib()
    dims = (ctypes.c_long * 3)()
    code = ctypes.c_int()
    comp = ctypes.c_int()
    if lib.octseg_mhd_info(path.encode(), dims, ctypes.byref(code),
                           ctypes.byref(comp)) != 0:
        raise IOError(f"cannot parse MetaImage header: {path}")
    return tuple(dims), np.dtype(_DTYPES[code.value]), bool(comp.value)


def load_mhd_volume_native(path: str) -> np.ndarray:
    """MetaImage volume -> (Z, Y, X) array, as ``retouch.load_mhd_volume``
    reads it."""
    lib = get_lib()
    dims, dtype, _ = mhd_info(path)
    z = dims[2] if dims[2] else 1
    out = np.empty((z, dims[1], dims[0]), dtype)
    if lib.octseg_mhd_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                           out.nbytes) != 0:
        raise IOError(f"cannot read MetaImage payload: {path}")
    return out


class PrefetchReader:
    """Iterate volumes from ``paths`` in order, read and decompressed by a
    native thread pool ahead of the consumer."""

    def __init__(self, paths, n_threads: int = 4, queue_cap: int = 4):
        self._handle = None
        self._lib = get_lib()
        self._paths = list(paths)
        self._cap = 0
        for p in self._paths:
            dims, dtype, _ = mhd_info(p)
            z = dims[2] if dims[2] else 1
            self._cap = max(self._cap, z * dims[1] * dims[0] * dtype.itemsize)
        self._buf = np.empty(max(self._cap, 1), np.uint8)
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        self._keepalive = arr  # the pool reads the paths after create
        self._handle = self._lib.octseg_prefetch_create(
            arr, len(self._paths), n_threads, queue_cap
        )

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        nbytes = ctypes.c_long()
        dims = (ctypes.c_long * 3)()
        code = ctypes.c_int()
        index = ctypes.c_int()
        rc = self._lib.octseg_prefetch_next(
            self._handle, self._buf.ctypes.data_as(ctypes.c_void_p),
            self._buf.nbytes, ctypes.byref(nbytes), dims,
            ctypes.byref(code), ctypes.byref(index),
        )
        if rc == 0:
            self.close()
            raise StopIteration
        if rc != 1:
            self.close()
            raise IOError("native prefetch read failed")
        dtype = np.dtype(_DTYPES[code.value])
        z = dims[2] if dims[2] else 1
        return np.frombuffer(
            self._buf[: nbytes.value].tobytes(), dtype
        ).reshape(z, dims[1], dims[0])

    def close(self):
        if self._handle is not None:
            self._lib.octseg_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def zscore_native(img: np.ndarray) -> np.ndarray:
    """In-place per-image z-score of a C-contiguous float32 array (the
    reference's ``trainTestModels.py:17``)."""
    if img.dtype != np.float32 or not img.flags["C_CONTIGUOUS"]:
        raise ValueError("zscore_native needs a C-contiguous float32 array, "
                         f"got {img.dtype}")
    get_lib().octseg_zscore(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), img.size
    )
    return img
