"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, loaded with `ctypes`. The build runs
at first use, from the sources in the checkout only, into
`bcnf_tpu_torch/_build/` (listed in `.gitignore`); the library's file name
carries a hash of its source and the shared headers, so an edited source is
rebuilt. `build_all` starts one nvcc per library at once. The three flow
sources are built twice: as they are (3xTF32, the default mode) and with
``-DBCNF_TF32_PASSES=1`` into a `*_tf32` library (one TF32 pass, the reduced
mode; `csrc/flow_rows.cuh`), so the second mode costs no build time beside
the first; so are K2b's `wgmma` route (`csrc/flow_train_wgmma.cu`), the
`wgmma` forward (`csrc/flow_fwd_wgmma.cu`), the wide inverse and forward at
Hp 768 and 1024 (`csrc/flow_wide_wgmma.cu`) and K2b there
(`csrc/flow_wide_train_wgmma.cu`, which takes flow_wide_wgmma.cu's device
parts: the hash of each of its builds covers both sources); 17 libraries
in all; the strict K1 and K2a (`csrc/flow_fma.cu`, float32 FMA)
and the strict K2b (`csrc/flow_train_fma.cu`, which takes flow_fma.cu's
device parts: its hash covers both sources) once. Nothing here runs at import
time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "ops" / "csrc"
SOURCES = {
    "flow_kernel": _CSRC / "flow_kernel.cu",  # K1 on the row tiles, K4, the training forward K2a
    "flow_fma": _CSRC / "flow_fma.cu",  # K1 in exact float32 (strict), both directions, and the strict K2a
    "flow_train_fma": _CSRC / "flow_train_fma.cu",  # the strict training backward K2b (float32 FMA)
    "flow_wgmma": _CSRC / "flow_wgmma.cu",  # K1's (and K4's) inverse on wgmma, Hp <= 544
    "flow_train_kernel": _CSRC / "flow_train_kernel.cu",  # the training backward K2b
    "lstm_kernel": _CSRC / "lstm_kernel.cu",  # the LSTM recurrence K3a and its backward K3b
}
ONE_PASS = "_tf32"  # the suffix of a flow library built for the reduced mode
# K2b's route on wgmma, Hp <= 544, and the forward (K1's, K2a's and K4's) on
# wgmma, each in 3xTF32 and (below) in one pass
SOURCES["flow_train_wgmma"] = _CSRC / "flow_train_wgmma.cu"
SOURCES["flow_fwd_wgmma"] = _CSRC / "flow_fwd_wgmma.cu"
SOURCES["flow_wide_wgmma"] = _CSRC / "flow_wide_wgmma.cu"  # K1's, K2a's and K4's walks at Hp 768 and 1024
SOURCES["flow_wide_train_wgmma"] = _CSRC / "flow_wide_train_wgmma.cu"  # K2b at Hp 768 and 1024
for _name in ("flow_kernel", "flow_wgmma", "flow_train_kernel", "flow_train_wgmma", "flow_fwd_wgmma",
              "flow_wide_wgmma", "flow_wide_train_wgmma"):
    SOURCES[_name + ONE_PASS] = SOURCES[_name]
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


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + (["-DBCNF_TF32_PASSES=1"] if name.endswith(ONE_PASS) else [])


# sources a library's source includes beside the headers
_INCLUDED = {"flow_train_fma": (_CSRC / "flow_fma.cu",), "flow_wide_train_wgmma": (_CSRC / "flow_wide_wgmma.cu",),
             "flow_wide_train_wgmma" + ONE_PASS: (_CSRC / "flow_wide_wgmma.cu",)}


def _library_path(name: str) -> Path:
    text = (SOURCES[name].read_bytes() + b"".join(p.read_bytes() for p in _INCLUDED.get(name, ()))
            + b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh"))))
    digest = hashlib.sha1(text + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named libraries (default: all) that have no library built
    from the same text yet, one nvcc each, all started together; returns the
    libraries' paths. A failed build raises with nvcc's output."""
    names = list(SOURCES) if names is None else names
    libs = {name: _library_path(name) for name in names}
    todo = [name for name in names if not libs[name].exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = libs[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (cmd, tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name} from {SOURCES[name].name}:\n{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile one source unless its library exists; returns its path."""
    return build_all([name])[name]


def resource_usage(name: str) -> dict[str, dict[str, int]]:
    """Each kernel's resources in a built library, by mangled name, as
    `cuobjdump -res-usage` reads them from the binary: registers a thread
    (REG, the launch count), and the bytes a thread keeps on the stack
    (STACK, where ptxas spills registers) and in local memory (LOCAL)."""
    import re

    out = subprocess.run([os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-res-usage", str(build(name))],
                         capture_output=True, text=True, check=True).stdout
    found = re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", out)
    return {fn: {"REG": int(r), "STACK": int(s), "LOCAL": int(loc)} for fn, r, s, loc in found}


def load_library(name: str = "flow_kernel") -> ctypes.CDLL:
    """Build (at first use) and load one kernel library, with its C entry
    points typed."""
    if name in _loaded:
        return _loaded[name]
    lib = ctypes.CDLL(str(build(name)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    source = name.removesuffix(ONE_PASS)
    if source == "flow_kernel":
        lib.bcnf_flow_rows.argtypes = [ptr] * 14 + [i32] * 8 + [ptr]
        lib.bcnf_flow_rows.restype = i32
    elif source == "flow_fma":
        lib.bcnf_fused_flow.argtypes = [ptr] * 13 + [i32] * 8 + [ptr]
        lib.bcnf_fused_flow.restype = i32
        lib.bcnf_fused_flow_train.argtypes = [ptr] * 15 + [i32] * 7 + [ptr]
        lib.bcnf_fused_flow_train.restype = i32
        lib.bcnf_flow_fma_layout.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
        lib.bcnf_flow_fma_layout.restype = i32
        lib.bcnf_flow_fma_keep.argtypes = [i32] * 6
        lib.bcnf_flow_fma_keep.restype = ctypes.c_longlong
    elif source == "flow_train_fma":
        lib.bcnf_flow_train_bwd_fma.argtypes = [ptr] * 25 + [i32] * 9 + [ptr]
        lib.bcnf_flow_train_bwd_fma.restype = i32
        lib.bcnf_flow_train_fma_scratch.argtypes = [i32] * 6
        lib.bcnf_flow_train_fma_scratch.restype = ctypes.c_longlong
        lib.bcnf_flow_train_fma_layout.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
        lib.bcnf_flow_train_fma_layout.restype = i32
    elif source == "flow_wgmma":
        lib.bcnf_flow_inverse_wgmma.argtypes = [ptr] * 12 + [i32] * 8 + [ptr]
        lib.bcnf_flow_inverse_wgmma.restype = i32
        lib.bcnf_flow_wgmma_occupancy.argtypes = [i32] * 3
        lib.bcnf_flow_wgmma_occupancy.restype = i32
        lib.bcnf_flow_wgmma_clusters.argtypes = [i32] * 3
        lib.bcnf_flow_wgmma_clusters.restype = i32
    elif source == "flow_wide_wgmma":
        lib.bcnf_flow_inverse_wide.argtypes = [ptr] * 12 + [i32] * 8 + [ptr]
        lib.bcnf_flow_inverse_wide.restype = i32
        lib.bcnf_flow_forward_wide.argtypes = [ptr] * 14 + [i32] * 9 + [ptr]
        lib.bcnf_flow_forward_wide.restype = i32
        lib.bcnf_flow_wide_layout.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
        lib.bcnf_flow_wide_layout.restype = i32
    elif source == "flow_wide_train_wgmma":
        lib.bcnf_flow_train_bwd_wide.argtypes = [ptr] * 24 + [i32] * 8 + [ptr]
        lib.bcnf_flow_train_bwd_wide.restype = i32
        lib.bcnf_flow_train_wide_scratch.argtypes = [i32] * 7
        lib.bcnf_flow_train_wide_scratch.restype = ctypes.c_longlong
        lib.bcnf_flow_train_wide_layout.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
        lib.bcnf_flow_train_wide_layout.restype = i32
    elif source == "flow_train_kernel":
        lib.bcnf_flow_train_bwd.argtypes = [ptr] * 24 + [i32] * 7 + [ptr]
        lib.bcnf_flow_train_bwd.restype = i32
        lib.bcnf_flow_train_bwd_scratch.argtypes = [i32] * 6
        lib.bcnf_flow_train_bwd_scratch.restype = ctypes.c_longlong
    elif source == "flow_train_wgmma":
        lib.bcnf_flow_train_bwd_wgmma.argtypes = [ptr] * 24 + [i32] * 7 + [ptr]
        lib.bcnf_flow_train_bwd_wgmma.restype = i32
        lib.bcnf_flow_train_wgmma_scratch.argtypes = [i32] * 6
        lib.bcnf_flow_train_wgmma_scratch.restype = ctypes.c_longlong
        lib.bcnf_flow_train_wgmma_layout.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
        lib.bcnf_flow_train_wgmma_layout.restype = i32
        lib.bcnf_prepare_train_weights.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.bcnf_prepare_train_weights.restype = i32
    elif source == "flow_fwd_wgmma":
        lib.bcnf_flow_fwd_wgmma.argtypes = [ptr] * 14 + [i32] * 7 + [ptr]
        lib.bcnf_flow_fwd_wgmma.restype = i32
        lib.bcnf_flow_fwd_wgmma_layout.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
        lib.bcnf_flow_fwd_wgmma_layout.restype = i32
    elif source == "lstm_kernel":
        lib.bcnf_lstm_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.bcnf_lstm_fwd.restype = i32
        lib.bcnf_lstm_fwd_layout.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.bcnf_lstm_fwd_layout.restype = i32
        lib.bcnf_lstm_bwd_rec.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.bcnf_lstm_bwd_rec.restype = i32
        lib.bcnf_lstm_bwd_dw.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.bcnf_lstm_bwd_dw.restype = i32
        lib.bcnf_lstm_bwd_scratch.argtypes = [i32] * 3
        lib.bcnf_lstm_bwd_scratch.restype = ctypes.c_longlong
        lib.bcnf_atb.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.bcnf_atb.restype = i32
    lib.bcnf_cuda_error_string.argtypes = [i32]
    lib.bcnf_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib
