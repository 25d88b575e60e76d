"""ctypes binding of the native (C++) train-time augmentation.

Counterpart of `structure_knowledge_distillation_tpu/data/native.py`:
`native/augment.cpp` compiles with g++ into a shared library with a plain C
interface on first use and loads through ctypes. The library goes to
`build/native/libskd_native_<hash>.so` at the repository root (git-ignored),
where `<hash>` covers the source, the flags and the host CPU's feature flags:
an edited source rebuilds, an unchanged one loads as it is, and a library
built with `-march=native` on one host is never loaded on another. The flags
are the JAX package's (`native/Makefile`), so both libraries round alike
(with `-march=native`, g++ contracts products and sums into FMAs where the
CPU has them, which moves a pixel by one against a build without).

One difference from the JAX package: a failed build raises, with the
compiler's output. Nothing falls back to the numpy path, which runs only when
a dataset is made with `use_native=False`.

The loaded library is module-global, so a dataset that uses it still pickles
into spawned loader workers; each worker loads the library on its first
sample.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["get_native_lib", "native_augment", "CXXFLAGS"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return platform.processor().encode()


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libskd_native_{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> None:
    """Compile under a cross-process file lock: spawned loader workers may all
    reach here at once. The first to take the lock compiles into a temporary
    name and renames it into place, so no process loads a half-written
    library; every later waiter finds it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if lib_path.is_file():
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            os.unlink(tmp)
            raise RuntimeError(f"the native augmentation cannot be built: {e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"the native augmentation failed to build "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib_path)


def get_native_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = _library_path()
            if not lib_path.is_file():
                _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.skd_augment.argtypes = [
                u8p, u8p, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, u8p, ctypes.c_int, f32p, i32p,
            ]
            lib.skd_augment.restype = None
            _lib = lib
        return _lib


def _ptr(arr: Optional[np.ndarray], ctype):
    if arr is None:
        return ctypes.cast(None, ctypes.POINTER(ctype))
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_augment(img: np.ndarray, label: Optional[np.ndarray], f_scale: float,
                   crop: tuple, h_off: int, w_off: int, flip: bool, mean: np.ndarray,
                   lut: Optional[np.ndarray], ignore_label: int = 255):
    """One-pass scale + LUT + mean-subtract + pad + crop + flip. Returns
    (image f32 HWC, label i32 HW or None)."""
    lib = get_native_lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.shape}")
    if label is not None:
        label = np.ascontiguousarray(label, np.uint8)
        if label.shape != img.shape[:2]:
            raise ValueError(f"label {label.shape} does not match image {img.shape}")
    crop_h, crop_w = crop
    out_img = np.empty((crop_h, crop_w, 3), np.float32)
    out_label = np.empty((crop_h, crop_w), np.int32) if label is not None else None
    mean = np.ascontiguousarray(mean, np.float32)
    if lut is not None:
        lut = np.ascontiguousarray(lut, np.uint8)
    lib.skd_augment(
        _ptr(img, ctypes.c_uint8), _ptr(label, ctypes.c_uint8),
        img.shape[0], img.shape[1],
        float(f_scale), crop_h, crop_w, int(h_off), int(w_off), int(flip),
        _ptr(mean, ctypes.c_float), _ptr(lut, ctypes.c_uint8),
        int(ignore_label),
        _ptr(out_img, ctypes.c_float), _ptr(out_label, ctypes.c_int32),
    )
    return out_img, out_label
