"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All of `csrc/*.cu` compiles into one shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/libskd_kernels_<hash>.so csrc/*.cu

`<hash>` covers the sources and the flags, so an edited kernel rebuilds and an
unchanged one loads from `build/kernels/` (git-ignored, at the repository
root). A build takes seconds; `torch.utils.cpp_extension.load`, whose sources
include PyTorch's headers, takes minutes and is deliberately not used.

The build runs on first use only, and only on a host with a CUDA device and
`nvcc`: anything else raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["load_kernels", "build_log", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
# name -> argtypes of each exported C function (restype is always int: the
# cudaError_t of the launch)
_SIGNATURES = {
    "skd_upsampled_argmax": [_c_void_p, _c_int, _c_void_p, _c_void_p, _c_void_p,
                             _c_void_p, _c_void_p, _c_int, _c_int, _c_int,
                             _c_int, _c_int, _c_int, _c_void_p],
}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return nvcc


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _library_path(srcs: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libskd_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output (with the ptxas register/spill report) of the library
    that `load_kernels` built or found, or '' if none is built yet."""
    log = _library_path(_sources()).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; argtypes are set."""
    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device; "
                           "CPU tensors take the plain PyTorch versions")
    srcs = _sources()
    lib_path = _library_path(srcs)
    if not lib_path.is_file():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build into a temporary name and rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        took = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        lib_path.with_suffix(".log").write_text(
            f"{' '.join(cmd)}\nbuilt in {took:.3f} s\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
