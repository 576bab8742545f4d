"""ctypes bindings for the native C++ ballistic engine (`native/ballistics.cpp`;
port of `bcnf_tpu/native.py`).

The engine integrates the velocity ODE with adaptive Dormand-Prince RK45 and
the reference's position and impact semantics, threaded across trajectories,
in float64 on the host. It is the adaptive-step oracle for the RK4 simulator.

The library is built at first use with g++ and the flags of
`native/Makefile`, from the checkout's source, into `bcnf_tpu_torch/_build/`
(listed in `.gitignore`); the file name carries a hash of the source and the
flags, so an edited source is rebuilt. Nothing is ever written into `native/`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "ballistics.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
LDFLAGS = ["-shared", "-pthread"]

PARAM_LAYOUT = [
    "x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z",
    "g_x", "g_y", "g_z", "w_x", "w_y", "w_z",
    "b", "m", "rho", "r", "a_x", "a_y", "a_z",
]


def _library_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes() + " ".join(CXXFLAGS + LDFLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libballistics-{digest}.so"


def build_library(force: bool = False) -> str:
    """Compile the engine if it is not built yet (g++, host only); returns
    the library's path. The build goes to a temporary file that is renamed
    into place, so concurrent processes never load a partial library."""
    lib = _library_path()
    if force or not lib.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXXFLAGS, str(_SOURCE), "-o", tmp, *LDFLAGS], check=True, capture_output=True)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return str(lib)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library())
    dp = ctypes.POINTER(ctypes.c_double)
    lib.simulate_trajectories.argtypes = [
        dp, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int, dp,
    ]
    lib.simulate_trajectories.restype = None
    lib.points_of_impact.argtypes = [dp, ctypes.c_int, ctypes.c_double, ctypes.c_int, dp]
    lib.points_of_impact.restype = None
    return lib


def params_matrix(params: dict[str, np.ndarray]) -> np.ndarray:
    """Pack a parameter dict into the engine's `(n, 19)` row layout."""
    cols = [np.asarray(params[k], dtype=np.float64) for k in PARAM_LAYOUT]
    return np.ascontiguousarray(np.stack(cols, axis=-1))


def _rows(params: np.ndarray | dict) -> np.ndarray:
    if isinstance(params, dict):
        params = params_matrix(params)
    params = np.ascontiguousarray(params, dtype=np.float64)
    if params.ndim != 2 or params.shape[1] != len(PARAM_LAYOUT):
        raise ValueError(f"params must be (n, {len(PARAM_LAYOUT)}), got {params.shape}")
    return params


def simulate_trajectories(
    params: np.ndarray | dict,
    T: float,
    dt: float,
    break_on_impact: bool = True,
    rtol: float = 1e-8,
    atol: float = 1e-10,
    n_threads: int | None = None,
) -> np.ndarray:
    """Simulate `(n, n_steps, 3)` trajectories with the native engine."""
    params = _rows(params)
    n = len(params)
    n_steps = int(np.ceil((T - 1e-12) / dt))
    out = np.empty((n, n_steps, 3), dtype=np.float64)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    dp = ctypes.POINTER(ctypes.c_double)
    _lib().simulate_trajectories(
        params.ctypes.data_as(dp), n, T, dt, int(break_on_impact),
        n_steps, rtol, atol, n_threads, out.ctypes.data_as(dp),
    )
    return out


def points_of_impact(
    params: np.ndarray | dict,
    dt: float = 0.1,
    n_threads: int | None = None,
) -> np.ndarray:
    """Ground-impact points `(n, 3)`; `[999]*3` sentinel for runaways."""
    params = _rows(params)
    n = len(params)
    out = np.empty((n, 3), dtype=np.float64)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    dp = ctypes.POINTER(ctypes.c_double)
    _lib().points_of_impact(params.ctypes.data_as(dp), n, dt, n_threads, out.ctypes.data_as(dp))
    return out
