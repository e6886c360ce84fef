"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, named by a hash of the sources,
the headers they share (``csrc/*.cuh``) and the flags, under ``_build/`` in
the package. The first call builds; later calls (and later processes)
reuse the library. Importing the package never builds.

The library is bound with ``ctypes``: every pointer and the stream are
passed as ``c_void_p`` (a bare Python int would be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (see the extern "C" functions in csrc/).
SIGNATURES = {
    "octseg_conv3x3_int8": [_P, _I, _P, _I, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _F, _F, _F, _F, _P, _P, _P, _I, _P, _P],
    "octseg_conv3x3_int8_mma": [_P, _I, _P, _I, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _F, _F, _P, _P, _P, _I, _P,
                                _I, _I, _I, _I, _I, _P],
    "octseg_conv3x3_int8_stem": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    "octseg_ct2x2_int8": [_P, _P, _P, _P, _I, _F, _P] + [_I] * 12 + [_P],
    "octseg_head_argmax": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    "octseg_head_argmax_resident": [_I, _I, _P],
    "octseg_conv3x3_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "octseg_conv3x3_bf16_mma": [_P, _P, _P] + [_I] * 10 + [_P],
    "octseg_conv3x3_bf16_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _P],
    "octseg_bn_pair_sums": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _L,
                            _I, _P],
    "octseg_bn_pair_sums_resident": [_I, _I, _I, _P],
    "octseg_bn_pair_sums_masked": [_P] * 6 + [_L, _I, _I, _I, _I, _I, _L,
                                              _I, _P],
    "octseg_bn_pair_sums_masked_resident": [_I, _I, _P],
    "octseg_bn_apply": [_P] * 4 + [_L] + [_I] * 7 + [_P],
    "octseg_bn_dx": [_P] * 8 + [_L] + [_I] * 7 + [_P],
    "octseg_bn_apply_resident": [_I] * 4 + [_P],
    "octseg_dice_ce_stats": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "octseg_dice_ce_stats_resident": [_I, _I, _I, _P],
    "octseg_dice_ce_bwd": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "octseg_dice_ce_bwd_resident": [_I, _I, _I, _P],
    "octseg_conv7x3_int8": [_P, _I, _P, _I, _P, _P, _P, _F, _P, _P, _P]
                           + [_I] * 12 + [_P],
    "octseg_stem_conv_int8": [_P] * 9 + [_I] * 8 + [_P],
    "octseg_stem_conv_int8_mma": [_P] * 9 + [_I] * 6 + [_P],
    "octseg_pool2x2_int8": [_P, _P, _I, _I, _I, _I, _I, _P],
    "octseg_column_softargmax": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot "
            "be built"
        )
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liboctseg_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = out.with_suffix(f".{tag}")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
    try:
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{stdout}\n{stderr}")
        done = subprocess.run(link, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({done.returncode}):\n"
                               f"{' '.join(link)}\n{done.stdout}\n"
                               f"{done.stderr}")
        os.replace(tmp, out)
    finally:
        for _, obj, proc in jobs:
            proc.wait()
            obj.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = loaded
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
