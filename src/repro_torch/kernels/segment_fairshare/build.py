"""Build ``csrc/segment_reduce.cu`` with nvcc and load it with ctypes.

The shared library has a plain C interface (no PyTorch headers), so a
build takes seconds.  It is built at first use, from the sources in this
checkout, into ``build/repro_torch/`` at the repository root; the file
name carries a hash of the source and the flags, so an edited source is
rebuilt and never mixed up with an old library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
ENTRY_POINTS = ("segment_sum_f64", "segment_min_f64")

_lib = None


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels of "
                       "repro_torch are built with it at first use")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsegment_reduce-{digest[:16]}.so"


def build() -> "tuple[Path, str]":
    """Compile the library unless it is already built.  Returns its path
    and nvcc's report (with ``-Xptxas -v``: registers and spills per
    kernel; empty when nothing was compiled)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.segment_reduce_error_string.argtypes = [ctypes.c_int]
        lib.segment_reduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
