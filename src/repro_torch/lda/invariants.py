"""Count-invariant tripwires: cheap structural self-checks on sampler state.

Port of ``src/repro/lda/invariants.py``: the same invariants, the same
``InvariantViolation(invariant, where, detail)`` and the same ``detail``
text, so a corrupted state trips the same check with the same message in
both packages.

ESCA's whole state is redundant by construction — ``D``, ``W``, and
``colsum`` are all derived from the token-topic assignment — and the
streaming pipelines keep a third copy of that redundancy in the deferred
ΔD/ΔW delta matrices. That redundancy is a free error detector: any
silent corruption (a bad host buffer, a miscompiled kernel, a logic bug
in an epoch apply) breaks at least one of the equalities below long
before it shows up as a bad model.

Enabled with ``LDAConfig(selfcheck=True)``, the checks run at epoch
close (streamed) or chunk boundaries (resident). Where the reference
copies the counts to the host and sums them with NumPy, the checks here
reduce each tensor **on its own device** — integer sums in int64, the
alias reconstruction in float64 (``scatter_add_`` in place of
``np.add.at``) — and read back one small vector of results. The integer
verdicts are exact on any device; the float64 reconstruction sums in
another order than NumPy, far inside its ``atol``. NumPy arrays are
taken as CPU tensors: the paged (disk) path's host-resident W and its
epoch ΔW (``HostPages.w`` / ``HostPages.dw``) live on the host by design
and are reduced there, to a (K,) or scalar result that meets the
device-resident counts on their device.

A failure raises :class:`InvariantViolation`, a ``RuntimeError``
subclass carrying ``(invariant, where, detail)``; the fit supervisor
(``LDAEngine.fit(supervise=...)``) classifies it as restartable and
walks back to the newest valid checkpoint.

Invariants:

  * **non_negative_counts** — no count cell ever goes below zero.
  * **token_conservation** — ``sum(D) == sum(W) == n_real_tokens``
    (padded tokens carry ``mask == 0`` and contribute nothing).
  * **colsum_matches_w** — the maintained per-topic total equals the
    column-sum of ``W``.
  * **delta_conservation** — mid-epoch ΔD/ΔW/Δcolsum each sum to zero
    (every token move is a −1 somewhere and a +1 somewhere else).
  * **packed_overflow** — the hybrid packed state never overflowed a
    bucket (``overflow == 0``).
  * **alias_tables_valid** — the warp sampler's Walker alias tables
    (core/mh.py) are well-formed: keep-probabilities in [0, 1], alias
    redirects in range, and the table-implied draw distribution
    reconstructs the q the tables were built from (a corrupted table
    silently biases every word proposal of the scan).
  * **theta_finite** / **finite_llpt** — fold-in θ and evaluation
    log-likelihood are finite (NaN poisoning trips here, not three
    epochs later).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["InvariantViolation", "ShardCorruptionError",
           "check_alias_tables", "check_count_totals", "check_dense_counts",
           "check_delta_conservation", "check_packed_counts",
           "check_theta"]


class InvariantViolation(RuntimeError):
    """A structural invariant of the sampler state failed.

    ``RuntimeError`` subclass so the fit supervisor treats it as
    restartable: the counts no longer describe the topic assignment, and
    the only safe continuation is from the newest valid checkpoint.
    """

    def __init__(self, invariant: str, where: str, detail: str):
        self.invariant = invariant
        self.where = where
        self.detail = detail
        super().__init__(
            f"invariant {invariant!r} violated at {where}: {detail} "
            "— restore from the newest checkpoint")


class ShardCorruptionError(RuntimeError):
    """A streamed shard's bytes failed their crc32 self-check on load."""


def _tensor(x) -> torch.Tensor:
    """A tensor on the device it already lives on (NumPy: the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _min0(t: torch.Tensor) -> torch.Tensor:
    """NumPy's ``t.min(initial=0)``: min(0, min(t)), 0 when empty."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.clamp(t.min(), max=0)


def _max0(t: torch.Tensor) -> torch.Tensor:
    """NumPy's ``t.max(initial=0)``."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.clamp(t.max(), min=0)


def _read(values, device) -> list:
    """Scalars reduced on their own devices -> host numbers, one readback."""
    return torch.stack([v.to(device, torch.float64) if v.is_floating_point()
                        else v.to(device, torch.int64).to(torch.float64)
                        for v in values]).tolist()


def check_dense_counts(D, W, colsum=None, *, n_tokens: int,
                       where: str) -> None:
    """Dense-count invariants: non-negative, token-conserving, and (when
    ``colsum`` is maintained) colsum == column-sum of W."""
    D, W = _tensor(D), _tensor(W)
    dev = D.device
    cols = W.sum(dim=0, dtype=torch.int64)            # on W's device
    vals = [_min0(D), _min0(W), D.sum(dtype=torch.int64), cols.sum()]
    bad = None
    if colsum is not None:
        cs = _tensor(colsum).to(dev, torch.int64)
        bad = cs != cols.to(dev)
        vals.append(bad.any())
    dmin, wmin, td, tw, *any_bad = (int(v) for v in _read(vals, dev))
    check_count_totals(dmin, wmin, td, tw, n_tokens=n_tokens, where=where)
    if any_bad and any_bad[0]:
        k = int(torch.argmax(bad.to(torch.int32)))
        raise InvariantViolation(
            "colsum_matches_w", where,
            f"colsum[{k}]={int(cs[k])} != sum(W[:, {k}])={int(cols[k])}")


def check_count_totals(dmin: int, wmin: int, td: int, tw: int, *,
                       n_tokens: int, where: str) -> None:
    """``check_dense_counts``' first two invariants on reduced totals: the
    minima of D and W and their sums (the distributed trainer reduces
    each rank's rows and replica block to these across its ranks)."""
    if dmin < 0 or wmin < 0:
        raise InvariantViolation(
            "non_negative_counts", where, f"min(D)={dmin}, min(W)={wmin}")
    if td != int(n_tokens) or tw != int(n_tokens):
        raise InvariantViolation(
            "token_conservation", where,
            f"sum(D)={td}, sum(W)={tw}, expected {int(n_tokens)}")


def check_delta_conservation(dD, dW, dcolsum=None, *,
                             where: str) -> None:
    """Mid-epoch delta invariants: every deferred ΔD/ΔW/Δcolsum sums to
    zero — a token moving topics is a −1 and a +1, never a net change."""
    named = [(name, _tensor(d)) for name, d in
             (("dD", dD), ("dW", dW), ("dcolsum", dcolsum)) if d is not None]
    if not named:
        return
    totals = _read([d.sum(dtype=torch.int64) for _, d in named],
                   named[0][1].device)
    for (name, _), total in zip(named, totals):
        if int(total) != 0:
            raise InvariantViolation(
                "delta_conservation", where,
                f"sum({name})={int(total)}, expected 0")


def check_packed_counts(colsum, overflow, *, n_tokens: int,
                        where: str) -> None:
    """Hybrid packed-state invariants: no bucket overflow, colsum
    non-negative and token-conserving."""
    cs = _tensor(colsum)
    ov, cmin, total = (int(v) for v in _read(
        [_tensor(overflow).reshape(()), _min0(cs), cs.sum(dtype=torch.int64)],
        cs.device))
    if ov != 0:
        raise InvariantViolation(
            "packed_overflow", where,
            f"{ov} packed-row inserts overflowed their bucket")
    if cmin < 0:
        raise InvariantViolation(
            "non_negative_counts", where, f"min(colsum)={cmin}")
    if total != int(n_tokens):
        raise InvariantViolation(
            "token_conservation", where,
            f"sum(colsum)={total}, expected {int(n_tokens)}")


def check_alias_tables(prob, alias, q=None, *, where: str,
                       atol: float = 1e-4) -> None:
    """Warp-sampler alias-table invariants (core/mh.AliasTables).

    A Walker table is valid iff every keep-probability lies in [0, 1],
    every alias redirect is a real topic, and — the load-bearing one —
    the distribution the table draws from reconstructs the proposal ``q``
    it was built for: mass(k) = Σ_j [prob[j]·(j==k) +
    (1−prob[j])·(alias[j]==k)] / K == q[k] per row.

    The reconstruction is computed with the redirects clamped into range,
    so all three verdicts come back in one readback; it is read only when
    the redirects are in range.
    """
    p = _tensor(prob).to(torch.float64)
    a = _tensor(alias).to(p.device, torch.int64)
    R, K = p.shape
    vals = [torch.isfinite(p).all(), _min0(p), _max0(p), _min0(a),
            _max0(a)]
    if q is not None:
        recon = p / K
        recon.scatter_add_(1, a.clamp(0, max(K - 1, 0)), (1.0 - p) / K)
        qd = _tensor(q).to(p.device, torch.float64)
        vals.append(torch.abs(recon - qd).max() if recon.numel()
                    else torch.zeros((), dtype=torch.float64))
        del recon, qd
    finite, pmin, pmax, amin, amax, *err = _read(vals, p.device)
    if not finite or pmin < 0.0 or pmax > 1.0 + 1e-6:
        raise InvariantViolation(
            "alias_tables_valid", where,
            f"keep-probabilities outside [0, 1]: min={pmin:.3g}"
            f", max={pmax:.3g}")
    if int(amin) < 0 or int(amax) >= K:
        raise InvariantViolation(
            "alias_tables_valid", where,
            f"alias redirects outside [0, {K}): min={int(amin)}"
            f", max={int(amax)}")
    if err and err[0] > atol:
        raise InvariantViolation(
            "alias_tables_valid", where,
            f"table mass deviates from q by {err[0]:.3g} (> {atol:g}): "
            "the word proposal no longer draws the distribution the "
            "acceptance ratio corrects for")


def check_theta(theta, *, where: str) -> None:
    """θ must be finite and non-negative (NaN/Inf poisoning tripwire)."""
    th = _tensor(theta)
    fin = torch.isfinite(th)
    n_bad, thmin = _read([(~fin).sum(), th.min() if th.numel()
                          else torch.zeros((), dtype=th.dtype)], th.device)
    if int(n_bad):
        raise InvariantViolation(
            "theta_finite", where,
            f"{int(n_bad)} non-finite entries in theta")
    if thmin < 0.0:
        raise InvariantViolation(
            "theta_finite", where, f"min(theta)={thmin:.3g} < 0")
