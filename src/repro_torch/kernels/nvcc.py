"""Build a kernel source with ``nvcc`` at first use and load it with ctypes.

Every CUDA source of the port (``csrc/*.cu``) has a plain C interface and
is compiled on its own into a shared library for ``sm_90a``, under
``_build/`` beside this file (git-ignored), named by a hash of the source
and the flags so an edited source is rebuilt. Builds are serialised by a
file lock, so parallel test workers share one build. Nothing here runs at
import time: the CPU has no ``nvcc``, and the tests import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC")

_loaded: dict[str, tuple[ctypes.CDLL, str]] = {}
_locks: dict[str, threading.Lock] = {}
_guard = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the port's "
                       "CUDA kernels are built from source at first use")


def load(name: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it.

    Returns the library and the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel). Raises if ``nvcc``
    fails; the caller sets the ctypes signatures. Two sources build in
    parallel when loaded from two threads.
    """
    with _guard:
        one = _locks.setdefault(name, threading.Lock())
    with one:
        if name in _loaded:
            return _loaded[name]
        source = CSRC / f"{name}.cu"
        src = source.read_bytes()
        tag = hashlib.sha256(
            src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = _BUILD_DIR / f"lib{name}_{tag}.so"
        log = _BUILD_DIR / f"lib{name}_{tag}.log"
        with open(_BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)       # one nvcc build per source
            if not so.exists():
                tmp = so.with_suffix(f".tmp{os.getpid()}")
                proc = subprocess.run(
                    [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(source)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {source.name}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                log.write_text(proc.stdout + proc.stderr)
                os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _loaded[name] = (lib, log.read_text() if log.exists() else "")
        return _loaded[name]
