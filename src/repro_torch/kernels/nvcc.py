"""Build and bind one CUDA source of ``csrc/``: nvcc into a shared
library with a plain C interface, loaded through ``ctypes``.

Every kernel library of the port goes through :class:`CudaLibrary`. A
library is built at first use, from the package's own source, into
``build/`` at the repository root (``.gitignore`` lists it), under a
name that carries a hash of that source, so an edited kernel is never
served from a stale build and two libraries never share a file. Nothing
here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``. Two libraries may be built at once from two
threads (``subprocess.run`` releases the GIL), which is how
``chip_smoke.py`` starts every nvcc together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parents[1]           # src/repro_torch
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parents[1] / "build"                # <repo>/build
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (needed to build the port's CUDA "
                       "kernels); put the CUDA toolkit's bin/ on PATH or "
                       "set CUDA_HOME")


class CudaLibrary:
    """One ``csrc/<name>.cu`` as a ctypes library.

    ``signatures`` maps each exported C function to its ``argtypes``
    (every function returns an ``int`` CUDA error code, 0 on success);
    ``error_fn`` names the exported ``const char* (int)`` that turns a
    code into its message."""

    def __init__(self, name: str, signatures: Dict[str, List[Any]],
                 error_fn: str) -> None:
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures
        self.error_fn = error_fn
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        # what the one build of this process took: seconds, library path
        # and nvcc's -Xptxas -v report (registers, shared memory, spills)
        self.build_info: Dict[str, Any] = {}

    def _build(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{self.name}-{digest}.so"
        if out.exists():
            self.build_info.update(seconds=0.0, path=str(out), cached=True,
                                   ptxas="")
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".tmp-",
                                   suffix=".so")
        os.close(fd)
        cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
               str(self.source)]
        t0 = time.monotonic()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)   # atomic: a concurrent builder sees all
        finally:                   # or nothing of the library
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_info.update(seconds=time.monotonic() - t0, path=str(out),
                               cached=False, ptxas=proc.stderr)
        return out

    def library(self) -> ctypes.CDLL:
        """The loaded kernel library (built on first call)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self._build()))
                for fn_name, argtypes in self.signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                err = getattr(lib, self.error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def check(self, code: int, what: str) -> None:
        """Raise if a launch returned a CUDA error (a refused launch
        never runs, and a later synchronize would not report it)."""
        if code != 0:
            msg = getattr(self.library(), self.error_fn)(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
