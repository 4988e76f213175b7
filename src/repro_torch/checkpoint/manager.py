"""Atomic, step-indexed checkpointing.

Port of ``src/repro/checkpoint/manager.py``, kept whole (it imports no
JAX, but the port carries its own copy): the same ``step_XXXXXXXX.npz``
files, the same ``__checksum__`` (sha256 over the sorted keys and their
bytes), so a file written by either package restores in the other.

  * **atomic** — a crash mid-save never corrupts the restore path: payloads
    are written to ``.tmp-<nonce>`` and ``os.replace``d into place
    (rename is atomic on POSIX), and the directory is fsynced after;
  * **step-indexed + retained** — ``keep_n`` newest checkpoints survive, so
    a corrupted latest (torn external copy, bad disk) still restores;
  * **self-validating** — every payload carries a checksum; restore_latest
    walks backwards past unreadable/corrupt files instead of crashing.
"""

from __future__ import annotations

import hashlib
import os
import re
import uuid
import zipfile
from typing import Any

import numpy as np

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


def _checksum(payload: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(payload):
        h.update(k.encode())
        h.update(np.ascontiguousarray(payload[k]).tobytes())
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, payload: dict[str, Any]) -> str:
        arrs = {k: np.asarray(v) for k, v in payload.items()}
        arrs["__checksum__"] = np.frombuffer(
            _checksum(arrs).encode(), dtype=np.uint8)
        tmp = os.path.join(self.dir, f".tmp-{uuid.uuid4().hex}")
        final = os.path.join(self.dir, f"step_{step:08d}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)                 # atomic publish
        # fsync the directory too: the rename itself must be durable, or a
        # power cut after save() can leave neither tmp nor final on disk
        try:
            dirfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:
            pass                   # platforms without directory fsync
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            try:
                os.remove(os.path.join(self.dir, f"step_{s:08d}.npz"))
            except OSError:
                pass
        # sweep orphaned tmp files from crashed saves
        for name in os.listdir(self.dir):
            if name.startswith(".tmp-"):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int) -> dict[str, np.ndarray] | None:
        path = os.path.join(self.dir, f"step_{step:08d}.npz")
        try:
            with np.load(path) as z:
                arrs = {k: z[k] for k in z.files}
        except (OSError, ValueError, zipfile.BadZipFile, KeyError, EOFError):
            return None
        want = arrs.pop("__checksum__", None)
        if want is None or bytes(want.tobytes()).decode() != _checksum(arrs):
            return None                        # torn/corrupt file
        return arrs

    def restore_latest(self, log_fn=None,
                       validate=None) -> dict[str, np.ndarray] | None:
        """Newest valid checkpoint, skipping corrupt ones (fault tolerance).

        ``log_fn`` (optional) is told about every checkpoint that was
        skipped as unreadable/corrupt, so a walk-back is visible, not
        silent.

        ``validate`` (optional) is a semantic gate on top of the checksum:
        ``validate(payload) -> bool`` (False or an exception rejects). Use
        it to walk past checkpoints that are intact on disk but unusable
        in the current run.
        """
        for step in reversed(self.all_steps()):
            payload = self.restore(step)
            if payload is not None and validate is not None:
                try:
                    if not validate(payload):
                        payload = None
                except Exception:
                    payload = None
                if payload is None and log_fn is not None:
                    log_fn(f"checkpoint step {step} is intact but failed "
                           "semantic validation; walking back to the "
                           "previous one")
                    continue
            if payload is not None:
                return payload
            if log_fn is not None:
                log_fn(f"checkpoint step {step} unreadable or corrupt; "
                       "walking back to the previous one")
        return None
