"""The serving tier: an always-on fold-in service (port of
``src/repro/serve``).

Layers, bottom up:

  * ``cache``    — hot-word tables: pinned head, tail parked on the host,
    bitwise the full tables, tear-free refresh;
  * ``replicas`` — replicas with their own tables and packed fold-in
    (token packing, alias warm start, the ``sample_fused`` and
    ``histogram`` kernels);
  * ``service``  — micro-batching front, backpressure, work-stealing
    dispatch, graceful drain;
  * ``refresh``  — bounded-staleness snapshots from the live trainer;
  * ``metrics``  — latency, queue, fill, cache and staleness counters.
"""

from repro_torch.serve.cache import HotWordCache
from repro_torch.serve.metrics import LatencyHistogram, ServeMetrics
from repro_torch.serve.refresh import ServingSnapshot, attach
from repro_torch.serve.replicas import Replica, ReplicaDead, ReplicaSet
from repro_torch.serve.service import (LDAService, ServeConfig, ServiceClosed,
                                       ServiceOverloaded)

__all__ = [
    "HotWordCache", "LDAService", "LatencyHistogram", "Replica",
    "ReplicaDead", "ReplicaSet", "ServeConfig", "ServeMetrics",
    "ServiceClosed", "ServiceOverloaded", "ServingSnapshot", "attach",
]
