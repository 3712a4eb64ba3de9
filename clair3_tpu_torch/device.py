"""The ``--device`` choice shared by the CLI, the server, the trainer and
the demo."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """The ``--device`` choice; ``cuda`` without a visible GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible to "
                           "torch (use --device cpu to run on the CPU)")
    return device
