"""The port's device policy, in one place.

Entry points take ``device="cuda"`` by default and compute there. A request
for the card on a machine without one raises; the CPU is used only when the
caller names it.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` (array, list or tensor) as a tensor on ``device``."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # torch refuses to alias read-only numpy memory
    return torch.as_tensor(x, dtype=dtype, device=resolve(device))
