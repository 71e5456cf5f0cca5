"""The device an entry point runs on when the caller names none.

Every constructor, converter and loader of the port takes ``device=None``,
which means the current CUDA device.  There is no silent CPU fallback and no
environment switch: on a machine without a card, ``device=None`` raises, and
the caller asks for the CPU with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a `torch.device`; None is the current CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "csgn_tpu_torch runs on the CUDA device by default, and torch finds none; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())
