"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a visible GPU
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device} (use 'cuda' or 'cpu')")
    return device
