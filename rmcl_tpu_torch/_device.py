"""The device rule shared by every entry point that creates tensors."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no card.

    Entry points default to ``"cuda"``; on a machine without a card they
    raise here instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
