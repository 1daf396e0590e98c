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
Kernel B counts its forward as `deform` and each backward pass as
`deform_bwd` (one launch, two when the scalars' gradient is asked for).
Kernel C counts every launch as `blend_fwd`, its checkpoint-mode launches
(a differentiated forward) also as `blend_fwd_ckpt` and its tile-major
launches also as `blend_fwd_tiles`. Kernel D is
three launches, each with its own count (`blend_bwd_ckpt`, `blend_bwd_sums`,
`blend_bwd_rows`); `blend_bwd` counts whole backward passes (D1s and D2
launched, after D1 or after kernel C's checkpoint mode).
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
    # -fmad=false: bit-for-bit the plain versions' op order, forward and
    # backward (launch-bound, so contraction buys nothing)
    "deform": ("deform.cu", ["-fmad=false"]),
    # -fmad=false: alpha's Gaussian exponent must round as the plain version
    # computes it, or an alpha within rounding of the 1/255 test is dropped
    # where the plain version keeps it (an FMA-contracted exponent did, on a
    # pixel of the SMPL-X training step); kernel D recomputes the same alpha
    "blend_fwd": ("blend_fwd.cu", ["-fmad=false"]),
    "blend_bwd": ("blend_bwd.cu", ["-fmad=false"]),
}

LAUNCHES = {name: 0 for name in (*SOURCES, "deform_bwd", "blend_fwd_ckpt", "blend_fwd_tiles",
                                  "blend_bwd_ckpt", "blend_bwd_sums", "blend_bwd_rows")}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C entry points of each library: {symbol: argtypes}
_SIGNATURES = {
    "knn": {"knn_small_refs": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                               _PTR, _PTR, _PTR]},
    "deform": {"deform_threads": [],
               "deform_rows": [_PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR],
               "deform_rows_bwd": [_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _PTR,
                                   _PTR, _PTR, _PTR]},
    "blend_fwd": {"blend_fwd": [_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _INT,
                                _INT, _INT, _INT, _INT, _INT, _INT, _PTR,
                                _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]},
    "blend_bwd": {
        "blend_bwd_ckpt": [_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                           _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR],
        "blend_bwd_sums": [_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                           _INT, _INT, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                           _PTR],
        "blend_bwd_rows": [_PTR, _INT, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                           _INT, _INT, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                           _PTR, _PTR, _PTR],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def capture_graph(warmup, program, stream, pool):
    """Run warmup() on the side `stream` (it builds the libraries and sizes
    the library workspaces, as PyTorch's notes on CUDA graphs prescribe),
    then capture program() there into a `torch.cuda.CUDAGraph` in `pool`
    -> (graph, program()'s output, the launches the capture recorded). The
    capture runs nothing, so its launches are taken back out of LAUNCHES;
    `count_replay` adds them per replay. A failed capture raises."""
    import contextlib

    import torch

    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        warmup()
    before = dict(LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            out = program()
        except BaseException:
            with contextlib.suppress(Exception):
                graph.capture_end()
            raise
        graph.capture_end()
    current.wait_stream(stream)
    launches = {n: LAUNCHES[n] - c for n, c in before.items() if LAUNCHES[n] != c}
    for name, n in launches.items():
        LAUNCHES[name] -= n
    return graph, out, launches


def count_replay(launches: dict) -> None:
    """Count a replay's launches: those its capture recorded."""
    for name, n in launches.items():
        LAUNCHES[name] += n


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
    seconds each took (0.0 when already built). Raises if one fails.
    BUILD_LOGS holds each one's nvcc output (ptxas registers and spills),
    kept beside the library so that a build done earlier still shows it."""
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
    for name in names:
        log = _target(name)[0].with_suffix(".log")
        if name not in procs and log.exists():
            BUILD_LOGS[name] = log.read_text()
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
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
        for symbol, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: cudaError {err}")
