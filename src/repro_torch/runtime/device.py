"""Where the port runs: the card, unless the caller asks for the CPU.

Every entry point of the port resolves its ``device`` argument here.
``None`` means the CUDA card; with no card visible that is an error, never
a quiet fall back to the CPU. The CPU runs only when asked for by name
(``device="cpu"``), as the tests do: there every kernel wrapper takes its
plain-PyTorch twin.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the card by "
                "default; pass device='cpu' to run its plain-PyTorch path "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(dev)!r} asked for, but no CUDA "
                           "device is visible")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={str(dev)!r}: the port runs on 'cuda' "
                         "or 'cpu'")
    return dev
