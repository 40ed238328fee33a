"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. The default is the card;
    asking for CUDA where there is none raises instead of carrying on
    quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jpdse_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run on the CPU"
        )
    return dev
