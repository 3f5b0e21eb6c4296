"""The device rule of the port's entry points.

``device=None`` means ``"cuda"``.  Without a card the caller must ask for
the CPU explicitly (``device="cpu"``, as the tests do): an entry point never
carries on quietly on the CPU when the card it was meant for is missing.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on; raises without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mujoco_maze_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev
