"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` compiles into its own shared library with a plain C
interface, all sources at once, one nvcc process each:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/<name>_<hash>.so csrc/<name>.cu

`<hash>` covers the source and the flags, so an edited kernel rebuilds and an
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
import types
from pathlib import Path

import torch

from structure_knowledge_distillation_tpu_torch.utils import spans

__all__ = ["load_kernels", "build_log", "tracing", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_c_int64 = ctypes.c_int64
# name -> argtypes of each exported C function (restype is always int: the
# cudaError_t of the launch)
_SIGNATURES = {
    "skd_bn_fwd": [*[_c_void_p] * 4, _c_int, _c_int, _c_int, _c_int, _c_int64, _c_float,
                   _c_int, _c_int, _c_void_p],
    "skd_bn_sums": [*[_c_void_p] * 7, _c_int, _c_int, _c_int, _c_int, _c_int64, _c_float,
                    _c_int, _c_int, _c_void_p],
    "skd_bn_bwd": [*[_c_void_p] * 8, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int64,
                   _c_float, _c_int, _c_int, _c_void_p],
    "skd_mark": [_c_void_p, _c_int, _c_int, _c_void_p],
    "skd_conv3x3": [*[_c_void_p] * 3, _c_int, *[_c_int] * 5, _c_void_p],
    "skd_conv3x3_wgmma": [*[_c_void_p] * 3, *[_c_int] * 5, _c_void_p],
    "skd_upsampled_argmax": [_c_void_p, _c_int, *[_c_void_p] * 6, *[_c_int] * 8, _c_void_p],
    "skd_upsampled_ce_fwd": [_c_void_p, _c_void_p, _c_int, _c_int, *[_c_void_p] * 11,
                             *[_c_int] * 7, _c_float, _c_int, _c_int, _c_void_p],
    "skd_upsampled_ce_bwd": [_c_void_p, _c_void_p, _c_int, _c_int, *[_c_void_p] * 13,
                             *[_c_int] * 7, _c_float, *[_c_int] * 3, _c_void_p],
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


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output (with the ptxas register/spill report) of the libraries
    that `load_kernels` built or found, or '' if none is built yet."""
    logs = [_library_path(src).with_suffix(".log") for src in _sources()]
    return "".join(log.read_text() for log in logs if log.is_file())


def _build_missing(srcs: list[Path]) -> None:
    """Start one nvcc per source that has no library yet, all at once, and
    wait for all of them. Each builds into a temporary name and is renamed,
    so a concurrent process never loads a half-written library."""
    todo = [src for src in srcs if not _library_path(src).is_file()]
    if not todo:
        return
    spans.count("kernels.built", len(todo))
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    t0 = time.perf_counter()
    try:
        for src in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((src, tmp, cmd, proc))
        failures = []
        for src, tmp, cmd, proc in jobs:
            out, _ = proc.communicate()
            took = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
                continue
            lib_path = _library_path(src)
            lib_path.with_suffix(".log").write_text(
                f"{' '.join(cmd)}\nbuilt in {took:.3f} s\n{out}")
            os.replace(tmp, lib_path)
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def tracing() -> bool:
    """True while `torch.export` or `torch.compile` traces, or while a
    `FakeTensorMode` is active (`utils/flops.py` counts under one): the
    tensors made then are fake, so no cache may keep them and no kernel may
    read their data."""
    return (torch.compiler.is_compiling()
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None)


def load_kernels() -> types.SimpleNamespace:
    """Build (if needed) and load the kernel libraries; returns the exported
    C functions of `_SIGNATURES` as attributes, with their argtypes set.

    Raises while `torch.export` or `torch.compile` traces or a
    `FakeTensorMode` is active (`tracing`): a launch reads the data pointers
    of real tensors, which a traced program does not have, and a program
    that called these libraries would not be self-contained. Every wrapper
    asks for the libraries before it touches a CUDA tensor's data or the
    device tables, so a traced CUDA forward stops here."""
    if tracing():
        raise RuntimeError("the port's CUDA kernels cannot be traced (torch.export, "
                           "torch.compile): trace a model without them (bn_fused=False, "
                           "resize and argmax as plain torch ops)")
    return _load_kernels()


@functools.cache
def _load_kernels() -> types.SimpleNamespace:
    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device; "
                           "CPU tensors take the plain PyTorch versions")
    with spans.span("kernels.load"):
        srcs = _sources()
        _build_missing(srcs)
        libs = [ctypes.CDLL(str(_library_path(src))) for src in srcs]
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        found = [getattr(lib, name) for lib in libs if hasattr(lib, name)]
        if len(found) != 1:
            raise RuntimeError(f"{name} is exported by {len(found)} kernel libraries, not 1")
        fn = found[0]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(**fns)
