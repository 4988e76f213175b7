"""Fused three-branch sampling: a CUDA kernel and its plain-PyTorch twin.

Replaces the TPU kernel ``src/repro/kernels/sample_fused.py::sample_fused``
(``pallas_call`` at line 234). Per token it computes the exact branch
masses (M, S', Q') from the token's D row and Ŵ row, draws
x = u·(M+S'+Q'), and returns K1 when x < M, else the first topic k ≠ K1
whose running sum of (D[k]+α)·Ŵ[k] exceeds x − M (K−1 if none does).

Two entry points:

``sample_fused_rows(u, doc, word, D, W_hat, alpha=)`` — the main path's.
  The kernel gathers each token's rows itself by doc and word id, so no
  (N, K) row matrix is ever built.
``sample_fused(u, d_rows, w_rows, alpha=)`` — the reference's signature on
  pre-gathered rows, kept as the parity entry point. It runs the same
  kernel with doc = word = arange(N).

On the card the kernel (``csrc/sample_fused.cu``) is bound by bytes: each
token reads its two K-wide rows once (at most N·K·8 B) plus 28 B of its
own. It is built with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` beside this file, and loaded with ``ctypes``.

The wrapper takes the plain twin only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fall back.
``sample_fused_rows.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.ref import sample_fused_ref

__all__ = ["sample_fused", "sample_fused_rows", "sample_fused_rows_plain",
           "build"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sample_fused.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC")
_PLAIN_TILE = 4096         # tokens per gathered tile in the plain twin

_lib: ctypes.CDLL | None = None
_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the "
                       "sample_fused kernel is built from source at first use")


def build() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source version) and load the kernel library.

    Returns the loaded library and the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel).
    """
    global _lib, _build_log
    if _lib is not None:
        return _lib, _build_log
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"libsample_fused_{tag}.so"
    log = _BUILD_DIR / f"libsample_fused_{tag}.log"
    with open(_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)       # one builder per checkout
        if not so.exists():
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SOURCE.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.sample_fused_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.sample_fused_launch.restype = ctypes.c_int
    lib.sample_fused_error_string.argtypes = [ctypes.c_int]
    lib.sample_fused_error_string.restype = ctypes.c_char_p
    lib.sample_fused_max_topics.argtypes = []
    lib.sample_fused_max_topics.restype = ctypes.c_int
    _lib, _build_log = lib, log.read_text() if log.exists() else ""
    return _lib, _build_log


def sample_fused_rows_plain(u, doc, word, D, W_hat, *, alpha: float):
    """The kernel's plain-PyTorch twin, on any device: gather rows tile by
    tile (bounding live memory), then ``ref.sample_fused_ref``."""
    n = u.shape[0]
    dev = u.device
    topic = torch.empty(n, dtype=torch.int32, device=dev)
    m, s, q = (torch.empty(n, dtype=torch.float32, device=dev)
               for _ in range(3))
    for lo in range(0, n, _PLAIN_TILE):
        hi = min(lo + _PLAIN_TILE, n)
        topic[lo:hi], m[lo:hi], s[lo:hi], q[lo:hi] = sample_fused_ref(
            u[lo:hi], D[doc[lo:hi].long()], W_hat[word[lo:hi].long()],
            alpha=alpha)
    return topic, m, s, q


def _check(u, doc, word, D, W_hat) -> None:
    n = u.shape[0]
    for name, t, dtype, ndim in (("u", u, torch.float32, 1),
                                 ("doc", doc, torch.int32, 1),
                                 ("word", word, torch.int32, 1),
                                 ("D", D, torch.int32, 2),
                                 ("W_hat", W_hat, torch.float32, 2)):
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"sample_fused: {name} must be a contiguous "
                             f"{ndim}-d {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != u.device:
            raise ValueError(f"sample_fused: {name} is on {t.device}, u on "
                             f"{u.device}")
    if doc.shape[0] != n or word.shape[0] != n:
        raise ValueError("sample_fused: u, doc and word differ in length")
    if D.shape[1] != W_hat.shape[1] or D.shape[1] < 1:
        raise ValueError(f"sample_fused: D {tuple(D.shape)} and W_hat "
                         f"{tuple(W_hat.shape)} need one K >= 1")
    if n:
        d_lo, d_hi, w_lo, w_hi = torch.stack(
            [doc.min(), doc.max(), word.min(), word.max()]).tolist()
        if d_lo < 0 or d_hi >= D.shape[0] or w_lo < 0 \
                or w_hi >= W_hat.shape[0]:
            raise ValueError("sample_fused: a doc or word id lies outside "
                             "D or W_hat")


def sample_fused_rows(u: torch.Tensor, doc: torch.Tensor, word: torch.Tensor,
                      D: torch.Tensor, W_hat: torch.Tensor, *, alpha: float):
    """Draw topics for N tokens whose rows are D[doc] and W_hat[word].

    Args: u (N,) f32 uniforms in [0, 1); doc, word (N,) int32; D (M, K)
    int32; W_hat (V, K) f32. Returns (topic int32, M, S', Q' f32), each (N,).
    """
    _check(u, doc, word, D, W_hat)
    if u.device.type == "cpu":
        return sample_fused_rows_plain(u, doc, word, D, W_hat, alpha=alpha)
    if u.device.type != "cuda":
        raise ValueError(f"sample_fused: unsupported device {u.device}")
    lib, _ = build()
    n, k = u.shape[0], D.shape[1]
    if k > lib.sample_fused_max_topics():
        raise ValueError(f"sample_fused: K={k} rows exceed one block's "
                         "shared memory")
    topic = torch.empty(n, dtype=torch.int32, device=u.device)
    m, s, q = (torch.empty(n, dtype=torch.float32, device=u.device)
               for _ in range(3))
    if n == 0:
        return topic, m, s, q
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        code = lib.sample_fused_launch(
            u.data_ptr(), doc.data_ptr(), word.data_ptr(), D.data_ptr(),
            W_hat.data_ptr(), topic.data_ptr(), m.data_ptr(), s.data_ptr(),
            q.data_ptr(), n, k, float(alpha), stream)
    if code != 0:
        raise RuntimeError("sample_fused kernel launch failed: "
                           + lib.sample_fused_error_string(code).decode())
    sample_fused_rows.launches += 1
    return topic, m, s, q


sample_fused_rows.launches = 0


def sample_fused(u: torch.Tensor, d_rows: torch.Tensor, w_rows: torch.Tensor,
                 *, alpha: float):
    """Sample topics from pre-gathered (D, Ŵ) rows (the reference's
    signature): the same kernel with doc = word = arange(N)."""
    n = d_rows.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=d_rows.device)
    return sample_fused_rows(u, ids, ids, d_rows, w_rows, alpha=alpha)
