"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, loaded with `ctypes`. The build runs
at first use, from the sources in the checkout only, into
`bcnf_tpu_torch/_build/` (listed in `.gitignore`); the library's file name
carries a hash of its source, so an edited source is rebuilt. Nothing here
runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"flow_kernel": _PKG / "ops" / "csrc" / "flow_kernel.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str) -> Path:
    """Compile `SOURCES[name]` unless a library built from the same source
    exists; returns the library's path. A failed build raises with nvcc's
    output."""
    src = SOURCES[name]
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src.name}:\n{' '.join(cmd)}\n{build_logs[name]}")
    os.replace(tmp, lib)
    return lib


def load_library(name: str = "flow_kernel") -> ctypes.CDLL:
    """Build (at first use) and load one kernel library, with its C entry
    points typed."""
    if name in _loaded:
        return _loaded[name]
    lib = ctypes.CDLL(str(build(name)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "flow_kernel":
        lib.bcnf_fused_flow.argtypes = [ptr] * 13 + [i32] * 8 + [ptr]
        lib.bcnf_fused_flow.restype = i32
    lib.bcnf_cuda_error_string.argtypes = [i32]
    lib.bcnf_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib
