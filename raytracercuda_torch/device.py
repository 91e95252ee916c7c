"""The device the port's entry points run on.

Every entry point that allocates takes ``device=None``, which means the
card.  Without a card such a call raises: it never carries on on the CPU.
Pass ``device="cpu"`` to run the plain PyTorch versions there.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device``, or the CUDA device when it is None.  Raises
    `RuntimeError` when a CUDA device is asked for and torch has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run its plain versions on the CPU")
    return dev
