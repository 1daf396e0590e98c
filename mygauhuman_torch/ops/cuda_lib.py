"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled by one `nvcc` call into a shared library with a
plain C interface under `build/torch_kernels/`, for `sm_90a` (Hopper), and
loaded with `ctypes` at first use. The library name carries a hash of the
source and flags, so an edited source is never served by a stale build.
`build()` starts one `nvcc` per source, all at once. A kernel that does not
build raises: there is no fallback.

Every C entry point returns `cudaGetLastError()` after its launch; the
wrappers pass it to `check()`, which raises on anything but 0.

`LAUNCHES` counts kernel launches per kernel name. A wrapper adds one right
after it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels (`reset_launches()` before, read after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# kernel name -> (source file, extra nvcc flags)
SOURCES = {
    # -fmad=false: the distance sum must round exactly as the plain version
    # does, or near-ties pick a different neighbour
    "knn": ("knn.cu", ["-fmad=false"]),
    # -fmad=false: bit-for-bit the plain version's op order (launch-bound,
    # so contraction buys nothing)
    "deform": ("deform.cu", ["-fmad=false"]),
    "blend_fwd": ("blend_fwd.cu", []),
    "blend_bwd": ("blend_bwd.cu", []),
}

LAUNCHES = {name: 0 for name in SOURCES}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C signature of each entry point: (symbol, argtypes)
_SIGNATURES = {
    "knn": ("knn_small_refs", [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                               _PTR, _PTR, _PTR]),
    "deform": ("deform_rows", [_PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR]),
    "blend_fwd": ("blend_fwd", [_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT,
                                _INT, _INT, _INT, _INT, _INT, _INT, _PTR,
                                _PTR]),
    "blend_bwd": ("blend_bwd", [_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _INT,
                                _INT, _INT, _PTR, _INT, _PTR, _PTR]),
}

_loaded: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> tuple[Path, list[str]]:
    src, flags = SOURCES[name]
    path = CSRC / src
    cmd_flags = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", *flags]
    digest = hashlib.sha256(
        path.read_bytes() + " ".join(cmd_flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so", cmd_flags


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (all by default) in parallel; returns the
    seconds each took (0.0 when already built). Raises if one fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out, flags = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    if name not in _loaded:
        out, _ = _target(name)
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: cudaError {err}")
