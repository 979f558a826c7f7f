"""Conv building blocks with the reference's parameter names.

BatchNorm is frozen, as the reference freezes all pretrained BN: the
statistics and affine parameters are constants, applied in inference
form ``(x - mean) * weight / sqrt(var + 1e-5) + bias`` whatever the
module's train flag.  Its parameters stay float32 while the convolutions
may run in bf16 (``cast_convs``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state-dict keys) that always normalizes
    with its running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class ConvBN(nn.Module):
    """Conv (no bias) -> frozen BN -> optional ReLU; ``conv`` / ``bn``
    children.  Padding defaults to ``(k - 1) * dilation // 2``."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1,
                 padding: Optional[int] = None, relu: bool = True):
        super().__init__()
        pad = (kernel_size - 1) * dilation // 2 if padding is None \
            else padding
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, pad,
                              dilation, bias=False)
        # momentum 0.001 is flax's 0.999; the statistics never update here
        self.bn = FrozenBatchNorm2d(cout, eps=1e-5, momentum=0.001)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x, inplace=True) if self.relu else x


def max_pool_ceil() -> nn.MaxPool2d:
    """3x3 stride-2 pad-1 ceil-mode max pool (the stem's)."""
    return nn.MaxPool2d(3, 2, 1, ceil_mode=True)


def cast_convs(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every ``nn.Conv2d`` under ``module`` to ``dtype`` (the compute
    dtype), leaving the frozen BN parameters in float32."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype)
    return module


class WeightCache:
    """Kernel-ready forms of a module's weights, built on first use and
    rebuilt only when one of the parameters is replaced (``.to``,
    ``load_state_dict`` into new storage) or changed in place."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, params: Sequence[torch.Tensor],
            build: Callable[[], Any]) -> Any:
        key = tuple((p.data_ptr(), p._version) for p in params)
        if key != self._key:
            with torch.no_grad():
                self._value = build()
            self._key = key
        return self._value
