"""Build the CUDA sources of ``csrc/`` with nvcc at first use, load with ctypes.

Each source compiles to an object file in its own nvcc process, all
started together, and one more nvcc links the objects into a shared
library with a plain C interface (no PyTorch headers), so the build takes
seconds. The library lands in ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of the sources, the shared header and the
flags: an edited source builds anew, an unchanged one is loaded from the
cache. Importing this module needs no nvcc; ``load()`` does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("scd_fused.cu", "scd_candidates.cu", "bucket_hist.cu",
           "screen_bound.cu", "adjusted_topc.cu")
HEADERS = ("scd_common.cuh", "hist_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_LOCK = threading.Lock()
_LOADED: dict = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built from source at first use")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libscd_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands side by side; raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(logs)


def build() -> tuple[Path, str]:
    """Compile the sources unless the cached library is current.

    Returns (library path, compiler log); the log holds ptxas' register
    and shared-memory report, and is empty when the cache was hit.
    """
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{Path(s).stem}.o" for s in SOURCES]
        log = _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                        for s, o in zip(SOURCES, objs)])
        lib = Path(tmp) / out.name
        log += _run_all([[nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, out)
    return out, log


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with its C
    signatures declared. Every pointer and the stream are c_void_p."""
    with _LOCK:
        lib = _LOADED.get("lib")
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build()[0]))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.scd_fused_hist_launch.argtypes = [vp] * 9 + [i64, i32, i32, i32, i32, vp]
        lib.scd_finalize_hist_launch.argtypes = ([vp] * 11
                                                 + [i64, i32, i32, i32, i32, i32, vp])
        lib.scd_candidates_launch.argtypes = [vp] * 5 + [i64, i32, i32, vp]
        lib.bucket_hist_launch.argtypes = [vp] * 7 + [i64, i32, i32, i32, vp]
        lib.screen_bound_launch.argtypes = [vp] * 5 + [i64, i32, i32, i64, vp]
        lib.adjusted_topc_launch.argtypes = [vp] * 5 + [i64, i32, i32, vp]
        for fn in (lib.scd_fused_hist_launch, lib.scd_finalize_hist_launch,
                   lib.scd_candidates_launch, lib.bucket_hist_launch,
                   lib.screen_bound_launch, lib.adjusted_topc_launch):
            fn.restype = i32
        lib.scd_finalize_part_stride.argtypes = [i32, i32]
        lib.scd_finalize_part_stride.restype = i32
        lib.scd_finalize_smem_bytes.argtypes = [i32, i32, i32]
        lib.scd_finalize_smem_bytes.restype = ctypes.c_size_t
        lib.hist_smem_bytes.argtypes = [i32, i32, i32, i32]
        lib.hist_smem_bytes.restype = ctypes.c_size_t
        lib.hist_scratch.argtypes = [i64, i32, i32, i32, i32]
        lib.hist_scratch.restype = i64
        lib.scd_error_string.argtypes = [i32]
        lib.scd_error_string.restype = ctypes.c_char_p
        _LOADED["lib"] = lib
        return lib
