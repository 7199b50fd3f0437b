"""Build the package's CUDA kernels with nvcc and bind them through ctypes.

``csrc/*.cu`` compile, at first use, into one shared library with a plain
C interface under ``kmer_spans_tpu_torch/build/`` (a file named by a hash
of the sources and flags, so an edited source builds anew), which is then
loaded with ``ctypes``.  Each C entry point launches one kernel on the
stream it is given and returns ``cudaGetLastError()``.  Any build or load
failure raises: there is no fallback.

Nothing here runs at import: the CPU tests import every module and have no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

#: sm_90a: Hopper with its architecture-specific features; no fast-math
#: flags, so float arithmetic stays IEEE
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # aug, n, k, counts, num_sms, stream
    "kst_count_aug": (_P, ctypes.c_int64, ctypes.c_int32, _P,
                      ctypes.c_int32, _P),
    # aug, nb, block, words, n_words, class_bits, thr_q, out, stream
    "kst_screen_scan": (_P, ctypes.c_int64, ctypes.c_int32, _P,
                        ctypes.c_int32, ctypes.c_int32, _P, _P, _P),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's standard prefix
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of kmer_spans_tpu_torch cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"libkst_cuda_{h.hexdigest()[:16]}.so"


def compile_library() -> tuple[Path, str]:
    """Compile csrc/*.cu unless the library is already built.

    Returns (path, nvcc's diagnostics); the diagnostics hold ptxas's
    register and shared-memory report for each kernel, and are empty
    when the library was already there.  Raises RuntimeError when nvcc
    fails.
    """
    out = _library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out, res.stdout + res.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        path, _ = compile_library()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
