"""Mid-epoch payload extension for the parameter-server trainer.

Port of ``src/repro/checkpoint/ps_payload.py``, whole (plain NumPy): the
same keys, dtypes and checks, so a payload packed by either package
unpacks in the other.

A ``w_sync="ps"`` checkpoint is the canonical payload (epoch-start
``topics_global`` + rng + iteration — the consistent cut every backend
understands) plus ``ps_*`` extension keys describing the open round:

  * ``ps_cursors``      — (S,) per-worker delta cursors: how many token
    sub-shards of the open round each worker has swept (and pushed).
  * ``ps_done_topics``  — the done sub-shards' CURRENT topics,
    concatenated per worker.  Everything else about the partial round —
    the device D deltas and the un-committed pushes sitting in the
    server's round queue — is a histogram diff between these and the
    epoch-start topics, so restores *re-derive* the in-flight deltas and
    re-push them instead of persisting a wire log (counts are derived
    state; DESIGN.md §15).
  * ``ps_owner_starts`` / ``ps_w_owner_<o>`` — the per-owner committed W
    row blocks at the cut.  Redundant with the canonical topics (and
    validated against them on restore — a mismatch is a corrupt
    checkpoint), but they let an owner restore its shard without a
    global topics scatter, and they make the payload self-describing for
    owner-count changes.
  * ``ps_clock`` — the aligned worker clock (== the server's committed
    round at the cut).
  * ``ps_stat_sums`` / ``ps_n_surv`` — the open round's per-worker
    partial stat sums (reporting state only; not part of the bitwise
    trajectory).

Backends that don't understand these keys can ignore them safely: the
canonical part alone restores at the cut, and redoing the round from
there reproduces the identical post-round state because the epoch
uniforms are derived from (key, iteration, worker coords) — that is the
cross-``w_sync`` interchange contract pinned in tests/test_torch_ps.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PS_PAYLOAD_PREFIX", "PSPayloadExt", "pack_ps_payload",
           "unpack_ps_payload"]

PS_PAYLOAD_PREFIX = "ps_"


@dataclasses.dataclass
class PSPayloadExt:
    """Decoded ``ps_*`` keys (see module docstring for semantics)."""
    clock: int
    cursors: np.ndarray            # (S,) int64
    done_topics: np.ndarray        # (sum cursors·L,) int32
    owner_starts: np.ndarray       # (n_owners+1,) int64
    owner_rows: list               # per-owner (R_o, K) int32
    stat_sums: np.ndarray | None   # (S, 4) float64
    n_surv: np.ndarray | None      # (S,) float64

    def gather_w(self) -> np.ndarray:
        """Dense (V, K) W from the stored owner blocks."""
        V = int(self.owner_starts[-1])
        K = self.owner_rows[0].shape[1] if self.owner_rows else 0
        out = np.zeros((V, K), np.int32)
        for o, blk in enumerate(self.owner_rows):
            a, b = int(self.owner_starts[o]), int(self.owner_starts[o + 1])
            out[a:b] = blk
        return out


def pack_ps_payload(*, server, cursors, done_topics, epochs) -> dict:
    """The ``ps_*`` extension keys for a mid-round PS checkpoint.

    ``server`` is the ``repro_torch.lda.ps.ParameterServer`` at the cut (its
    committed rows ARE the cut's W — partial-round pushes are queued, not
    applied); ``epochs`` the per-worker open-round carries (or None for
    workers between rounds), supplying the reporting-only stat sums.
    """
    S = len(cursors)
    stat_sums = np.zeros((S, 4), np.float64)
    n_surv = np.zeros(S, np.float64)
    for w, ep in enumerate(epochs):
        if ep is not None:
            stat_sums[w] = ep.stat_sums
            n_surv[w] = ep.n_surv
    out = {
        "ps_clock": np.int64(server.committed),
        "ps_cursors": np.asarray(cursors, np.int64),
        "ps_done_topics": np.asarray(done_topics, np.int32),
        "ps_owner_starts": np.asarray(server.layout.starts, np.int64),
        "ps_stat_sums": stat_sums,
        "ps_n_surv": n_surv,
    }
    for o in range(server.layout.n_owners):
        out[f"ps_w_owner_{o:05d}"] = server.rows[o].copy()
    return out


def unpack_ps_payload(payload: dict) -> PSPayloadExt | None:
    """Decode a payload's ``ps_*`` keys, or None when absent (a boundary
    or foreign-backend payload — the canonical part stands alone)."""
    if "ps_cursors" not in payload:
        return None
    starts = np.asarray(payload["ps_owner_starts"], np.int64)
    rows = []
    for o in range(len(starts) - 1):
        key = f"ps_w_owner_{o:05d}"
        if key not in payload:
            raise ValueError(
                f"ps payload names {len(starts) - 1} owners but lacks "
                f"{key}: corrupt checkpoint")
        rows.append(np.asarray(payload[key], np.int32))
    ss = payload.get("ps_stat_sums")
    nsv = payload.get("ps_n_surv")
    return PSPayloadExt(
        clock=int(np.asarray(payload["ps_clock"])),
        cursors=np.asarray(payload["ps_cursors"], np.int64),
        done_topics=np.asarray(payload["ps_done_topics"], np.int32),
        owner_starts=starts,
        owner_rows=rows,
        stat_sums=None if ss is None else np.asarray(ss, np.float64),
        n_surv=None if nsv is None else np.asarray(nsv, np.float64))
