"""Build the CUDA sources of ``csrc/`` with nvcc at first use, load with ctypes.

The shared library has a plain C interface (no PyTorch headers), so it
builds in seconds. It lands in ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of the sources and flags: an edited
source builds anew, an unchanged one is loaded from the cache. Importing
this module needs no nvcc; ``load()`` does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("scd_fused.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
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
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libscd_fused-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources unless the cached library is current.

    Returns (library path, compiler log); the log holds ptxas' register
    and shared-memory report, and is empty when the cache was hit.
    """
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with its C
    signatures declared. Every pointer and the stream are c_void_p."""
    with _LOCK:
        lib = _LOADED.get("lib")
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build()[0]))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.scd_fused_hist_launch.argtypes = [vp] * 7 + [i64, i32, i32, i32, i32, vp]
        lib.scd_fused_hist_launch.restype = i32
        lib.scd_finalize_hist_launch.argtypes = ([vp] * 7
                                                 + [i64, i32, i32, i32, i32, i32, vp])
        lib.scd_finalize_hist_launch.restype = i32
        for fn in (lib.scd_fused_smem_bytes, lib.scd_finalize_smem_bytes):
            fn.argtypes = [i32, i32, i32]
            fn.restype = ctypes.c_size_t
        lib.scd_error_string.argtypes = [i32]
        lib.scd_error_string.restype = ctypes.c_char_p
        _LOADED["lib"] = lib
        return lib
