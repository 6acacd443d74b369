"""Build a kernel package's ``csrc/*.cu`` with nvcc and load it with ctypes.

Every kernel library of the port has a plain C interface (no PyTorch
headers), so a build takes seconds.  It is built at first use, from the
sources in this checkout, into ``build/repro_torch/`` at the repository
root; the file name carries a hash of the source and the flags, so an
edited source is rebuilt and never mixed up with an old library.

Each entry point returns ``cudaGetLastError()`` of its launch (0 on
success); each library exports ``<name>_error_string(int)`` to turn that
code into CUDA's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


class CudaLibrary:
    """One ``.cu`` source built into ``lib<name>-<hash>.so``.

    ``entry_points`` maps each exported function to its ctypes argument
    types; every entry point returns an ``int`` CUDA error code.
    """

    def __init__(self, name: str, source: Path,
                 entry_points: "dict[str, list]"):
        self.name = name
        self.source = Path(source)
        self.entry_points = entry_points
        self._lib = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:16]}.so"

    def build(self) -> "tuple[Path, str]":
        """Compile the library unless it is already built.  Returns its
        path and nvcc's report (with ``-Xptxas -v``: registers, shared
        memory and spills per kernel; empty when nothing was compiled)."""
        out = self.library_path()
        if out.exists():
            return out, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out, proc.stdout + proc.stderr

    def load(self) -> ctypes.CDLL:
        """The built library with every entry point's signature set."""
        if self._lib is None:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in self.entry_points.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, kernel: str, entry: str, *args) -> None:
        """Launch ``entry`` and raise if CUDA refused the launch."""
        lib = self.load()
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            msg = getattr(lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                               f"{rc} ({msg})")
