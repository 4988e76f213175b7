"""Errors the port raises when a structural invariant of its inputs fails.

Port of the part of ``src/repro/lda/invariants.py`` that the streaming and
disk paths need: ``ShardCorruptionError``. The count tripwires
(``InvariantViolation`` and the ``check_*`` functions behind
``config.selfcheck``) come with the failure model (ROADMAP.md Queue 1
#11).
"""

from __future__ import annotations

__all__ = ["ShardCorruptionError"]


class ShardCorruptionError(RuntimeError):
    """A streamed shard's bytes failed their crc32 self-check on load."""
