"""Device policy shared by the port's stages.

A stage's ``device`` Param names a torch device. Its default ``"cuda"``
means the card: on a host without one it raises rather than running on the
CPU, which a caller gets only by asking for ``"cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["device_type", "resolve_device"]


def device_type(spec) -> str | None:
    """The device type ``spec`` names, or None when it names none."""
    try:
        return torch.device(spec).type
    except RuntimeError:
        return None


def resolve_device(owner: str, spec) -> torch.device:
    """``spec`` as a device; "cuda" on a host without a card raises."""
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner}: device={str(spec)!r} but this host has no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return device
