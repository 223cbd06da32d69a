"""Where the port's entry points run: the card, unless the caller asks for
the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; without a CUDA device that raises instead of
    quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
