"""Device resolution for the port's entry points.

Every public entry point takes ``device=None``; ``None`` means the CUDA card.
There is no silent drop to the CPU: asking for CUDA on a machine without one
raises, and the CPU is used only when the caller names it.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.errors import DeviceUnavailable


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises :class:`DeviceUnavailable` when the
    resolved device is CUDA and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; the port runs on the card by "
            "default. Pass device='cpu' to run the plain PyTorch versions."
        )
    return dev
