"""The inference forward of the serving path.

``make_serving_fn`` returns ``fn(x) -> labels``: optional on-device
normalization of raw uint8 RGB, the model (fused prototype head when
``fast``), then the label upsample + argmax (the fused K3 kernel when
``fast``).  The ``jax.export`` artifact form is not part of the port yet.

A dynamic quant8 model (``quant8=True``) serves without ``fast``, as in
the JAX package; a static one serves with it once calibrated, and an
uncalibrated static model raises at its first quantized conv.
"""

from __future__ import annotations

from typing import Optional

import torch

from scaleprotoseg_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from scaleprotoseg_torch.kernels.upsample import (fused_upsample_argmax,
                                                  label_dtype)
from scaleprotoseg_torch.ops.resize import resize_bilinear_matrix


def make_serving_fn(model, *, output: str = "labels", upsample: bool = True,
                    fast: bool = False,
                    normalize_to: Optional[torch.dtype] = None):
    """``fn(x)`` for a batch ``x`` (B, H, W, 3) on the model's device.

    ``output='labels'`` returns (B, H, W) uint8 train ids (int32 above 255
    classes); ``'logits'`` the float32 (B, h, w, C) map, upsampled to the
    input size when ``upsample``.  ``normalize_to`` makes ``fn`` take raw
    uint8 and compute ``(x / 255 - mean) / std`` in float32 on the device,
    the same float32 ops as the host pipeline, then cast to this dtype."""
    if output not in ("labels", "logits"):
        raise ValueError(f"output must be labels|logits, got {output!r}")
    if getattr(model.features.base, "quant8", False) is True:
        fast = False
    device = next(model.parameters()).device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        height, width = x.shape[1], x.shape[2]
        if normalize_to is not None:
            x = ((x.float() / 255.0 - mean) / std).to(normalize_to)
        logits = model.fast_logits(x) if fast else model(x).logits
        if output == "labels":
            if upsample and fast:
                return fused_upsample_argmax(logits, height, width)
            if upsample:
                logits = resize_bilinear_matrix(logits, height, width)
            return logits.argmax(dim=-1).to(label_dtype(logits.shape[-1]))
        if upsample:
            logits = resize_bilinear_matrix(logits, height, width)
        return logits

    return fn
