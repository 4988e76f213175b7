"""Three-term roofline of one rank's step from a meta-device pass: port
of ``src/repro/roofline/analysis.py``.

    compute    = FLOPs        / peak FLOP/s      (per rank)
    memory     = bytes        / HBM bandwidth    (per rank)
    collective = wire bytes   / link bandwidth   (per rank)

The reference reads FLOPs and bytes from a compiled module's
``cost_analysis()`` and the collectives from its HLO text. The port has
no HLO: ``launch/dryrun.py`` runs one rank's real step on the meta
device against a ``runtime.sharding.PlanMesh`` (nothing allocated,
nothing computed), and this module counts what that pass does:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the pass (the
  matmuls, batched matmuls and einsums of every layer, micro-batch,
  recompute and backward: an eager pass counts each loop trip, where
  XLA's cost analysis counts a while-loop body once);
* bytes: ``Meter``, a ``TorchDispatchMode`` that adds the bytes every
  op reads (its tensor arguments) and writes (its outputs), views
  excluded: the HBM traffic of eager PyTorch, one op after another, no
  fusion;
* collectives: the plan mesh's ``traffic`` (kind, result bytes and
  group size of every call), through the reference's ring model
  (``collective_bytes``; ``runtime.sharding.ring_bytes`` is the formula,
  which a real ``ProcessMesh`` records the same way);
* memory: ``Meter`` also tracks the live storages (added when an op
  makes one, dropped when its last tensor is freed) from the step's
  arguments on, and ``summarize_memory`` reports their peak.

Hardware: ``HW`` keeps the reference's TPU v5e constants as it has them;
``H100`` is the card the port runs on, and the one the dry run uses.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.runtime.sharding import ring_bytes

__all__ = ["HW", "H100", "collective_bytes", "roofline_terms",
           "summarize_memory", "Meter", "meter_pass"]


@dataclasses.dataclass(frozen=True)
class HW:
    """The reference's hardware model: TPU v5e-like (its assignment's
    constants), kept as the reference has it. Not the port's card."""
    peak_flops: float = 197e12       # bf16 per chip
    hbm_bw: float = 819e9            # B/s per chip
    link_bw: float = 50e9            # B/s per link
    hbm_bytes: float = 16 * 2 ** 30  # v5e: 16 GiB HBM per chip


@dataclasses.dataclass(frozen=True)
class H100:
    """NVIDIA H100 SXM5 80 GB, from NVIDIA's data sheet: 989 TFLOP/s
    dense bf16 tensor-core peak (1,979 with 2:4 sparsity, not used),
    3.35 TB/s of HBM3, NVLink 4 at 900 GB/s a card both ways (450 GB/s
    each way), 80 GB. The peaks assume the 700 W power limit; a card
    capped lower (``nvidia-smi --query-gpu=power.limit``) runs slower
    under load."""
    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    hbm_bytes: float = 80e9
    power_limit_w: float = 700.0


# the port's kinds → the reference's HLO names
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "checkpoint": "all-gather", "reduce_scatter": "reduce-scatter",
          "all_to_all": "all-to-all",
          "collective_permute": "collective-permute"}


def collective_bytes(traffic) -> dict:
    """A rank's wire bytes by kind of collective under the reference's
    ring model, with its keys. ``traffic`` is a mesh's ``traffic`` (kind
    → [calls, bytes, {group size: [calls, result bytes]}]) or an
    iterable of ``(kind, result bytes, group size)`` calls."""
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0, "count": 0}
    if isinstance(traffic, dict):
        calls = [(kind, nbytes, g, n)
                 for kind, (_, _, by) in traffic.items()
                 for g, (n, nbytes) in by.items()]
    else:
        calls = [(kind, nbytes, g, 1) for kind, nbytes, g in traffic]
    for kind, nbytes, g, n in calls:
        if nbytes == 0:
            continue
        name = _KINDS.get(kind.replace("-", "_"), kind)
        out[name] += ring_bytes(kind, nbytes, g)
        out["count"] += n
    out["total"] = sum(v for k, v in out.items()
                       if k not in ("count", "total"))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Meter(TorchDispatchMode):
    """Counts a pass op by op: ``read`` and ``written`` bytes (every op
    but views), ``ops``, and the live storages' bytes (``now``, ``peak``)
    from ``inputs`` on: a storage is added when an op first returns a
    tensor of it and dropped when the last such tensor is freed."""

    def __init__(self, inputs=()):
        super().__init__()
        self.read = self.written = self.ops = 0
        self.now = self.peak = 0
        self._live: dict[int, list] = {}
        for t in tree_flatten(inputs)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(t)
        self.arguments = self.now

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [st.nbytes(), 0]
            self.now += ent[0]
            self.peak = max(self.peak, self.now)
        ent[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is not None:
            ent[1] -= 1
            if ent[1] == 0:
                del self._live[key]
                self.now -= ent[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.ops += 1
        if not func.is_view:
            self.read += sum(_nbytes(t) for t in tree_flatten(
                (args, kwargs))[0] if isinstance(t, torch.Tensor))
            self.written += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t)
        return out


def meter_pass(fn, *args, inputs=()):
    """Run ``fn(*args)`` under ``FlopCounterMode`` and a ``Meter`` whose
    live bytes start from ``inputs`` (what the rank holds before the
    step). Returns (fn's result, FLOPs, meter, seconds)."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, Meter(inputs) as meter:
        out = fn(*args)
    return out, fc.get_total_flops(), meter, time.perf_counter() - t0


def roofline_terms(flops: float, bytes_: float, traffic,
                   hw=H100()) -> dict:
    """The three terms (seconds) + dominant + raw counters for one cell,
    with the reference's keys: ``hlo_flops`` and ``hlo_bytes`` are the
    meta pass's FLOPs and op bytes."""
    coll = collective_bytes(traffic)
    terms = {
        "compute_s": flops / hw.peak_flops,
        "memory_s": bytes_ / hw.hbm_bw,
        "collective_s": coll["total"] / hw.link_bw,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "hlo_flops": float(flops),
        "hlo_bytes": float(bytes_),
        "collective_bytes": coll["total"],
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        # fraction of the roofline the dominant term would achieve if the
        # other two overlapped perfectly (the optimization target)
        "overlap_bound_frac": bound / total if total else 0.0,
    }


def summarize_memory(meter: Meter, outputs=()) -> dict:
    """A rank's memory over the pass, per device, with the reference's
    ``memory_analysis()`` keys where they mean something here:
    ``argument_size_in_bytes`` (what the rank holds before the step:
    params, optimizer state, cache, batch), ``output_size_in_bytes``
    (what the step returns), ``temp_size_in_bytes`` (the peak above the
    arguments) and ``peak_bytes_estimate`` (the peak of the live
    storages). ``alias_size_in_bytes`` and
    ``generated_code_size_in_bytes`` have none: an eager step makes its
    new state beside the old (no donation) and compiles no code; they
    are None, and ``not_meaningful`` names them."""
    seen, out_bytes = set(), 0
    for t in tree_flatten(outputs)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                out_bytes += st.nbytes()
    return {"argument_size_in_bytes": int(meter.arguments),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(meter.peak - meter.arguments),
            "alias_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
            "peak_bytes_estimate": int(meter.peak),
            "not_meaningful": ["alias_size_in_bytes",
                               "generated_code_size_in_bytes"]}
