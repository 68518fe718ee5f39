"""Where the port's entry points run."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str]) -> torch.device:
    """Entry points run on CUDA unless the caller asks for the CPU; with no
    CUDA and no CPU request they raise rather than fall back."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torchsnapshot_tpu_torch runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to run on the CPU.'
        )
    return dev
