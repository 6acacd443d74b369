"""Build a kernel package's ``csrc/*.cu`` with nvcc and load it with ctypes.

Every kernel library of the port has a plain C interface (no PyTorch
headers), so a build takes seconds.  It is built at first use, from the
sources in this checkout, into ``build/repro_torch/`` at the repository
root; the file name carries a hash of the source, of every local header
it includes (``#include "..."``, beside it, followed through the headers'
own includes) and of the flags, so an edited source or header is rebuilt
and never mixed up with an old library.

Each entry point returns ``cudaGetLastError()`` of its launch (0 on
success); each library exports ``<name>_error_string(int)`` to turn that
code into CUDA's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def local_includes(source: Path) -> "list[Path]":
    """The headers ``source`` includes with ``#include "..."``, resolved
    beside the file that names them, then theirs, each once, in the order
    met."""
    found, todo = [], [Path(source)]
    while todo:
        path = todo.pop(0)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            header = (path.parent / name.decode()).resolve()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


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


class LaunchWord:
    """Named unsigned fields packed into one integer, the first field in
    the lowest bits, for a C entry point's arguments that stay the same
    from call to call: ctypes converts every argument anew on each call,
    and at decode that host time is most of a call's.  The entry point
    decodes the same layout; ``pack`` raises where a value does not fit
    its field, so nothing is cut silently."""

    def __init__(self, **widths: int):
        self.fields = {}
        shift = 0
        for name, width in widths.items():
            self.fields[name] = (shift, width)
            shift += width
        if shift > 63:
            raise ValueError(f"launch word of {shift} bits: at most 63")

    def pack(self, **values: int) -> int:
        if values.keys() != self.fields.keys():
            raise ValueError(f"launch word fields {sorted(values)}, want "
                             f"{sorted(self.fields)}")
        word = 0
        for name, value in values.items():
            shift, width = self.fields[name]
            if not 0 <= value < 1 << width:
                raise ValueError(f"launch word field {name}={value} does "
                                 f"not fit in {width} bits")
            word |= value << shift
        return word

    def unpack(self, word: int) -> "dict[str, int]":
        return {name: word >> shift & (1 << width) - 1
                for name, (shift, width) in self.fields.items()}


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
        self.functions = {}
        self._lib = None
        self._error_string = None

    def library_path(self) -> Path:
        """The library's path, named by a hash of the source, its local
        headers and the flags."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in local_includes(self.source):
            digest.update(header.name.encode() + b"\0" + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

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
        """The built library with every entry point's signature set; each
        entry point stays bound in ``functions``."""
        if self._lib is None:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            functions = {}
            for fn_name, argtypes in self.entry_points.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                functions[fn_name] = fn
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._error_string = err
            self.functions = functions
            self._lib = lib
        return self._lib

    def function(self, entry: str):
        """The bound ctypes function of ``entry`` (built and loaded at
        first use)."""
        if self._lib is None:
            self.load()
        return self.functions[entry]

    def fail(self, kernel: str, rc: int) -> None:
        """Raise for the CUDA error code ``rc`` of a launch."""
        msg = self._error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")

    def call(self, kernel: str, entry: str, *args) -> None:
        """Launch ``entry`` and raise if CUDA refused the launch."""
        rc = self.function(entry)(*args)
        if rc != 0:
            self.fail(kernel, rc)
