"""The device an entry point runs on: ``cuda`` unless the caller names
another, an error where CUDA is asked for and absent."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA
    is asked for (or defaulted to) and absent."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev
