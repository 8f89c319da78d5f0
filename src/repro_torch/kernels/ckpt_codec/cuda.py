"""Build and bind ``csrc/ckpt_codec.cu``: nvcc into a shared library
with a plain C interface, loaded through ``ctypes``.

The library is built at first use, from the package's own source, into
``build/`` at the repository root (``.gitignore`` lists it), under a
name that carries a hash of the source, so an edited kernel is never
served from a stale build. Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc``.
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
from typing import Any, Dict, Optional

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCE = _PKG / "csrc" / "ckpt_codec.cu"
BUILD_DIR = _PKG.parents[1] / "build"               # <repo>/build
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the one build of this process took: seconds, library path and
# nvcc's -Xptxas -v report (registers, shared memory, spills)
build_info: Dict[str, Any] = {}

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "ckpt_fingerprint": [_VP, _LL, _LL, _VP, _VP],
    "ckpt_fused_capture": [_VP, _LL, _LL, _VP, _INT, _VP, _VP, _VP, _VP,
                           _VP, _VP],
    "ckpt_xor": [_VP, _VP, _VP, _LL, _VP],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (needed to build the CUDA "
                       "checkpoint-codec kernels); put the CUDA toolkit's "
                       "bin/ on PATH or set CUDA_HOME")


def _build() -> Path:
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    out = BUILD_DIR / f"libckpt_codec-{digest}.so"
    if out.exists():
        build_info.update(seconds=0.0, path=str(out), cached=True,
                          ptxas="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".tmp-", suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(SOURCE)]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent builder sees all or
    finally:                   # nothing of the library
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info.update(seconds=time.monotonic() - t0, path=str(out),
                      cached=False, ptxas=proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ckpt_error_string.argtypes = [ctypes.c_int]
            lib.ckpt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = library().ckpt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
