"""Conv building blocks with the reference's parameter names.

BatchNorm is frozen in the DeepLab backbones, as the reference freezes
all pretrained BN: the statistics and affine parameters are constants,
applied in inference form ``(x - mean) * weight / sqrt(var + 1e-5) +
bias`` whatever the module's train flag.  The U-Net backbones of EM
(``freeze_type = 'none'``) hold ``TrainableBatchNorm2d``, whose
statistics a caller's ``train_bn`` updates, as flax's ``nn.BatchNorm``.
Their parameters stay float32 while the convolutions may run in bf16, in
one of two ways:

- serving: ``cast_convs`` casts the conv weights themselves;
- training: ``set_compute_dtype`` leaves the parameters float32 and each
  ``ConvBN`` casts its input and weight to the compute dtype at the call,
  as the JAX package's ``param_dtype=float32, dtype=bfloat16`` convs do,
  so the gradients reach float32 parameters.
"""

from __future__ import annotations

import contextlib
import math
from typing import (Any, Callable, Dict, Iterable, Iterator, Optional,
                    Sequence)

import torch
import torch.nn as nn
import torch.nn.functional as F

from scaleprotoseg_torch.ops import as_dtype
from scaleprotoseg_torch.ops.gradconv import conv3x3_dilated
from scaleprotoseg_torch.ops.quant import (dynamic_int8_conv, int8_conv,
                                           pack_int8_weight, static_int8_conv)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state-dict keys) that always normalizes
    with its running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class TrainableBatchNorm2d(FrozenBatchNorm2d):
    """flax's ``nn.BatchNorm(use_running_average=not train_bn,
    momentum=0.999, epsilon=1e-5)`` with ``nn.BatchNorm2d``'s state-dict
    keys.  ``train_bn=False`` normalizes with the running statistics.
    ``train_bn=True`` normalizes with the batch's mean and its biased
    variance, both in float32 whatever the input's dtype and the variance
    as flax's ``E[x^2] - E[x]^2`` clipped at 0, and moves the running
    statistics by ``0.999 * running + 0.001 * batch``, the variance
    biased too (``nn.BatchNorm2d`` would move them by the unbiased one).
    The output has the input's dtype; ``num_batches_tracked`` stays as it
    was (flax keeps no count)."""

    MOMENTUM = 0.999            # flax's: the weight of the running value

    def forward(self, x: torch.Tensor, train_bn: bool = False
                ) -> torch.Tensor:
        if not train_bn:
            return super().forward(x)
        # at least float32, as flax promotes the statistics' dtype
        xf = x if x.dtype == torch.float64 else x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dims)
        var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        m = self.MOMENTUM
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean +
                                    (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + \
            self.bias[:, None, None]
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Conv (no bias) -> BN -> optional ReLU; ``conv`` / ``bn`` children.
    Padding defaults to ``(k - 1) * dilation // 2``.  The BN is frozen,
    or with ``trainable_bn`` a ``TrainableBatchNorm2d`` that the
    forward's ``train_bn`` trains.

    ``fast_grad`` (a 'same' stride-1 3x3 conv only) computes the conv
    through ``ops.gradconv.conv3x3_dilated``: the same forward, the
    hybrid backward (``train.fast_gradconv``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1,
                 padding: Optional[int] = None, relu: bool = True,
                 fast_grad: bool = False, trainable_bn: bool = False):
        super().__init__()
        pad = (kernel_size - 1) * dilation // 2 if padding is None \
            else padding
        if fast_grad and (kernel_size != 3 or stride != 1 or
                          pad != dilation):
            raise ValueError("fast_grad takes 'same' stride-1 3x3 convs "
                             "only")
        self.fast_grad = fast_grad
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, pad,
                              dilation, bias=False)
        # momentum 0.001 is flax's 0.999 (TrainableBatchNorm2d updates by
        # flax's rule, not by this attribute)
        bn = TrainableBatchNorm2d if trainable_bn else FrozenBatchNorm2d
        self.bn = bn(cout, eps=1e-5, momentum=0.001)
        self.relu = relu
        self.compute_dtype: Optional[torch.dtype] = None  # None: weight's

    def forward(self, x: torch.Tensor, train_bn: bool = False
                ) -> torch.Tensor:
        conv = self.conv
        dt = self.compute_dtype or conv.weight.dtype
        x, w = as_dtype(x, dt), as_dtype(conv.weight, dt)
        if self.fast_grad:
            x = conv3x3_dilated(x, w, conv.dilation[0])
        else:
            x = F.conv2d(x, w, None, conv.stride, conv.padding,
                         conv.dilation)
        if train_bn:
            if not isinstance(self.bn, TrainableBatchNorm2d):
                raise ValueError("train_bn on a frozen BatchNorm")
            x = self.bn(x, train_bn=True)
        else:
            x = self.bn(x)
        return F.relu(x, inplace=True) if self.relu else x


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's default kernel init: a normal of variance 1 / fan_in
    truncated at two standard deviations."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class HeadConv(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` (None: its
    weight's), parameters untouched, as ``ConvBN`` does: the U-Net's 1x1
    head ``outc``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else as_dtype(self.bias, dt)
        return F.conv2d(as_dtype(x, dt), as_dtype(self.weight, dt), bias,
                        self.stride, self.padding, self.dilation)


class QuantConvBN(ConvBN):
    """``ConvBN`` whose conv runs as a w8a8 int8 convolution
    (``ops/quant.py``): the counterpart of the JAX package's
    ``_QuantConv``.  Same parameters and state-dict keys, so any
    checkpoint loads with ``strict=True``; the float32 conv weight is
    quantized per output channel once per set of weights.

    ``static=False`` (dynamic): the activation scale is computed per call.
    ``static=True``: the scale is the non-persistent buffer ``x_scale``
    (0 until calibrated).  While ``calibrating`` the module runs the float
    conv in the compute dtype and folds ``max|x| / 127`` into ``x_scale``,
    which later batches can only raise; serving an uncalibrated site
    raises.  ``plain`` routes the conv through the plain versions
    (``static_int8_conv`` / ``dynamic_int8_conv``) instead of the kernel
    dispatch ``int8_conv``: the reference path on the card.  The int8
    output is dequantized into the compute dtype."""

    def __init__(self, *args, static: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.static = static
        self.register_buffer("x_scale", torch.zeros((), dtype=torch.float32),
                             persistent=False)
        self.calibrated = False
        self.calibrating = False
        self.plain = False
        self._packed = WeightCache()

    def set_scale(self, value: torch.Tensor) -> None:
        """Load a calibrated activation scale (e.g. carried from JAX)."""
        with torch.no_grad():
            self.x_scale.copy_(torch.as_tensor(value, dtype=torch.float32))
        self.calibrated = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        dt = self.compute_dtype or conv.weight.dtype
        if self.calibrating:
            if not self.static:
                raise ValueError("only static quant8 sites calibrate")
            with torch.no_grad():
                torch.maximum(self.x_scale,
                              x.detach().float().abs().amax() / 127.0,
                              out=self.x_scale)
            self.calibrated = True
            y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                         conv.padding, conv.dilation)
        else:
            if self.static and not self.calibrated:
                raise ValueError(
                    "quant8='static' model served without calibrated "
                    "scales: run model_loading.calibrate_quant_scales "
                    "first (serve's --quant8-static does this on the "
                    "first inputs)")
            y = self._int8(x.permute(0, 2, 3, 1), dt).permute(0, 3, 1, 2)
        y = self.bn(y)
        return F.relu(y, inplace=True) if self.relu else y

    def _int8(self, xh: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        conv = self.conv
        scale = self.x_scale if self.static else None
        if self.plain:
            pad = [(p, p) for p in conv.padding]
            kw = dict(strides=conv.stride, padding=pad,
                      dilation=conv.dilation, out_dtype=dt)
            kernel = conv.weight.permute(2, 3, 1, 0)
            return static_int8_conv(xh, kernel, scale, **kw) if self.static \
                else dynamic_int8_conv(xh, kernel, **kw)
        k = conv.kernel_size[0]
        if conv.stride != (1, 1) or conv.padding != (
                (k - 1) * conv.dilation[0] // 2,) * 2 or k not in (1, 3):
            raise ValueError("int8 kernels take stride-1 'same' 1x1 and 3x3 "
                             "convs only")
        if "int8_wt" in self._buffers:            # held for export
            packed = (self.int8_wt, self.int8_sw)
        else:
            packed = self._packed.get([conv.weight], self._pack)
        return int8_conv(xh, packed, scale, conv.dilation[0], dt)

    def _pack(self):
        return pack_int8_weight(self.conv.weight.permute(2, 3, 1, 0).float())

    def packed_buffers(self) -> Dict[str, torch.Tensor]:
        """The quantized, transposed weight and its per-channel scales,
        for ``packed_as_buffers``."""
        if self.plain:
            return {}
        wt, sw = self._pack()
        return {"int8_wt": wt, "int8_sw": sw}


def max_pool_ceil(window: int = 3, stride: int = 2,
                  padding: int = 1) -> nn.MaxPool2d:
    """Ceil-mode max pool, 3x3 stride-2 pad-1 by default (the stem's);
    the JAX package's ``max_pool_ceil(x, window, strides, padding)``."""
    return nn.MaxPool2d(window, stride, padding, ceil_mode=True)


def cast_convs(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every ``nn.Conv2d`` under ``module`` to ``dtype`` (the compute
    dtype), leaving the frozen BN parameters in float32.  A
    ``QuantConvBN`` keeps its float32 weight (it is quantized from that,
    as the JAX package quantizes its float32 parameter) and computes in
    ``dtype``."""
    quant = {id(m.conv) for m in module.modules()
             if isinstance(m, QuantConvBN)}
    for m in module.modules():
        if isinstance(m, QuantConvBN):
            m.compute_dtype = dtype
        elif isinstance(m, nn.Conv2d) and id(m) not in quant:
            m.to(dtype)
    return module


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run every ``ConvBN`` and ``HeadConv`` under ``module`` in
    ``dtype``, parameters untouched (the training form of mixed
    precision)."""
    for m in module.modules():
        if isinstance(m, (ConvBN, HeadConv)):
            m.compute_dtype = dtype
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


@contextlib.contextmanager
def packed_as_buffers(modules: Iterable[nn.Module]) -> Iterator[None]:
    """Hold the packed weight form of each of ``modules`` that has one
    (``packed_buffers()``: K2's stack in ``ASPP``, K1's tables in
    ``PPNet``, the int8 weights in ``QuantConvBN``) as registered buffers
    while the block runs, built from the current weights.  The forward
    then reads them in place of the ``WeightCache``, whose key is a data
    pointer that a traced forward's fake tensors lack, and a program
    exported meanwhile (``torch.export``) carries them in its state.  The
    buffers are removed on exit; the eager caches are untouched."""
    held = []
    try:
        for m in modules:
            pack = getattr(m, "packed_buffers", None)
            if pack is None:
                continue
            with torch.no_grad():
                tensors = pack()
            for name, t in tensors.items():
                m.register_buffer(name, t.contiguous())
            held.append((m, list(tensors)))
        yield
    finally:
        for m, names in held:
            for name in names:
                delattr(m, name)
