"""PPNet: the prototype segmentation head over a feature backbone.

Pipeline (the public tensors are NHWC, as in the JAX package):
  backbone (+ the optional MSC input pyramid) -> add-on (a sigmoid, or
  the reference's 1x1-conv stacks) -> per-scale L2 prototype distances
  (with the optional scale head, coarse to fine) -> log activation ->
  last linear layer, or per-class group projection + exp + group last
  layer.

The MSC input pyramid (``msc_scales``, Pascal's ``(0.5, 0.75)``) runs the
backbone on the image and on each ``resize_bilinear_factor(x, p)``, and
fuses the maps by an elementwise max after resizing each pyramid map to
the base grid.  In training the model returns one output per map,
``[base, *pyramid, fused]``, and the losses average over them; otherwise
it returns the fused map's output alone.

Parameters carry the reference's names and layouts, so a state dict from
``checkpoints.convert.ppnet_params_to_statedict`` or the JAX package's
``convert_checkpoint export-torch`` loads with ``strict=True``:
``features.base.*``, ``prototype_vectors`` (P, D, 1, 1),
``last_layer.weight`` (C, P), or per non-empty class
``group_projection.{k}.weight`` (G, Pc) and ``last_layer_group.weight``
(C, G * #non-empty), the add-on's convs ``add_on_layers.{2i}.*`` and the
'concat' scale head's ``scale_head.output_layer.linear_block.0.*``.
``group_weights`` scatters the packed group weights
into the dense (C, G, Pc_max) / (C*G, C) layouts the head computes with.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scaleprotoseg_torch.kernels.proto import (KERNEL_TABLES, ProtoHead,
                                               fused_proto_logits,
                                               group_activations, pack_head)
from scaleprotoseg_torch.models.layers import (WeightCache, lecun_normal_,
                                               set_compute_dtype)
from scaleprotoseg_torch.ops import as_dtype
from scaleprotoseg_torch.ops.prototype import (distance_to_similarity,
                                               scale_l2_distances)
from scaleprotoseg_torch.ops.resize import (resize_bilinear,
                                            resize_bilinear_factor)
from scaleprotoseg_torch.ops.simplex import projection_simplex_sort
from scaleprotoseg_torch.spec import ProtoSpec


def group_projection_init(draw: torch.Tensor) -> torch.Tensor:
    """A fresh (G, Pc) group projection from a U(-1, 1) ``draw`` of that
    shape: torch ``nn.Linear``'s uniform init, ``draw / sqrt(Pc)``,
    projected onto the simplex (the reference projects at init), so the
    rows are sparse: entries under the projection's threshold are 0."""
    return projection_simplex_sort(
        draw * (1.0 / math.sqrt(max(draw.shape[-1], 1))))


class PPNetOutput(NamedTuple):
    logits: torch.Tensor                       # (B, Hp, Wp, C)
    distances: torch.Tensor                    # (B, Hp, Wp, Pa)
    activations: torch.Tensor                  # (B, Hp, Wp, Pa)
    group_activations: Optional[torch.Tensor]  # (B, Hp, Wp, C, G) | None


class Features(nn.Module):
    """Holds the backbone as ``base`` (the reference's ``features.base``).
    ``train_bn`` trains the backbone's BatchNorm (the U-Nets'; a backbone
    whose BN is frozen refuses it)."""

    def __init__(self, base: nn.Module):
        super().__init__()
        self.base = base

    def forward(self, x: torch.Tensor, train_bn: bool = False
                ) -> torch.Tensor:
        if not train_bn:
            return self.base(x)
        if not getattr(self.base, "trainable_bn", False):
            raise NotImplementedError(
                f"train_bn: {type(self.base).__name__}'s BatchNorm is "
                "frozen in the port (trainable BN exists for the U-Net "
                "backbones only)")
        return self.base(x, train_bn=True)


class AddOnLayers(nn.Module):
    """Backbone-to-prototype adapter (the reference's
    ``model_multiscale.py:174-218``), entered in the compute dtype (the
    ASPP hands float32 on), as the JAX package's ``AddOnLayers``:

    - 'deeplab_simple' (every shipped config): a plain sigmoid;
    - 'bottleneck': pairs of 1x1 convs halving the channels down to the
      prototype depth, ReLU after each conv but the last, which takes a
      sigmoid; 'bottleneck_pool' first a 3x3 conv of stride
      ``bottleneck_stride`` and a ReLU;
    - 'regular': 1x1 conv, ReLU, 1x1 conv, sigmoid.

    The convs are the reference's ``add_on_layers.{2i}`` (its Sequential
    puts an activation after each), kaiming-normal fan-out with zero
    bias, each computing in the compute dtype ``dtype``, its parameters
    untouched (serving casts them, ``layers.cast_convs``)."""

    def __init__(self, add_on_type: str, in_channels: int = 0,
                 proto_depth: int = 0,
                 bottleneck_stride: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        convs = []                      # (cin, cout, kernel, stride)
        self.acts = []                  # after each conv: 'relu' | 'sigmoid'
        if add_on_type.startswith("bottleneck"):
            if add_on_type == "bottleneck_pool":
                if not bottleneck_stride:
                    raise ValueError("add-on 'bottleneck_pool' needs "
                                     "PPNet(MultiScale).bottleneck_stride")
                convs.append((in_channels, in_channels, 3,
                              bottleneck_stride))
                self.acts.append("relu")
            elif add_on_type != "bottleneck":
                raise ValueError(f"Unknown add-on type {add_on_type!r}")
            cur, cin, first = in_channels, in_channels, True
            while cur > proto_depth or first:
                first = False
                out = max(proto_depth, cur // 2)
                convs += [(cin, out, 1, 1), (out, out, 1, 1)]
                self.acts += ["relu",
                              "relu" if out > proto_depth else "sigmoid"]
                cin, cur = out, cur // 2
        elif add_on_type == "regular":
            convs = [(in_channels, proto_depth, 1, 1),
                     (proto_depth, proto_depth, 1, 1)]
            self.acts = ["relu", "sigmoid"]
        elif add_on_type != "deeplab_simple":
            raise ValueError(f"Unknown add-on type {add_on_type!r}")
        for i, (cin, cout, k, stride) in enumerate(convs):
            conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)
            nn.init.kaiming_normal_(conv.weight, mode="fan_out",
                                    nonlinearity="relu")
            nn.init.zeros_(conv.bias)
            self.add_module(str(2 * i), conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = as_dtype(x, dt)
        if not self.acts:
            return torch.sigmoid(x)
        for i, act in enumerate(self.acts):
            conv = getattr(self, str(2 * i))
            x = F.conv2d(x, as_dtype(conv.weight, dt), as_dtype(conv.bias, dt),
                         conv.stride, conv.padding)
            x = torch.relu(x) if act == "relu" else torch.sigmoid(x)
        return x


class ScaleHead(nn.Module):
    """The reference's ``WeightedAgg`` (``scale_head.py``), the JAX
    package's ``ScaleHead``: a scale's features take in the previous
    (coarser) scale's activations through their prototypes, ``a @ p``:
    'sum' ``(x + a @ p) / 2``, 'mult' ``sqrt(x * (a @ p))``, 'concat'
    ``sigmoid(Linear(2D, D)([x, a @ p]))`` (the reference's
    ``output_layer.linear_block.0``, computed in the compute dtype)."""

    def __init__(self, output_type: str, channel_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output_type not in ("sum", "mult", "concat"):
            raise ValueError(f"Unknown scale head type {output_type!r}")
        self.output_type = output_type
        self.dtype = dtype
        if output_type == "concat":
            linear = nn.Linear(2 * channel_dim, channel_dim)
            lecun_normal_(linear.weight)
            nn.init.zeros_(linear.bias)
            self.output_layer = nn.Module()
            self.output_layer.linear_block = nn.Sequential(linear,
                                                           nn.Sigmoid())

    def forward(self, x: torch.Tensor, activations: torch.Tensor,
                prototypes: torch.Tensor) -> torch.Tensor:
        weight_sum = activations @ prototypes
        if self.output_type == "sum":
            return (x + weight_sum) / 2.0
        if self.output_type == "mult":
            return torch.sqrt(x * weight_sum)
        joint = torch.promote_types(x.dtype, weight_sum.dtype)
        h = torch.cat([x.to(joint), weight_sum.to(joint)], dim=-1)
        linear = self.output_layer.linear_block[0]
        dt = self.dtype
        return torch.sigmoid(F.linear(as_dtype(h, dt),
                                      as_dtype(linear.weight, dt),
                                      as_dtype(linear.bias, dt)))


class PPNet(nn.Module):
    """Prototype segmentation model (single-scale, multi-scale and grouped
    variants of the reference in one module, with the optional MSC input
    pyramid and the optional scale head).

    ``kernel_head`` (decided here, at construction): ``fast_logits`` runs
    K1, which computes the log activation of scale-free distances; with a
    scale head or another activation the head is the plain one, as the
    JAX package's ``fast_logits`` leaves its Pallas head out there."""

    def __init__(self, backbone: nn.Module, spec: ProtoSpec,
                 add_on_type: str = "deeplab_simple",
                 activation_fn: str = "log", grouped: bool = False,
                 incorrect_strength: float = -0.5,
                 msc_scales: Sequence[float] = (),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 backbone_channels: Optional[int] = None,
                 scale_head_type: Optional[str] = None,
                 bottleneck_stride: Optional[int] = None):
        super().__init__()
        self.spec = spec
        self.msc_scales = tuple(msc_scales)
        self.activation_fn = activation_fn
        self.grouped = grouped
        self.incorrect_strength = incorrect_strength
        self.dtype = dtype
        self.features = Features(backbone)
        self.add_on_layers = AddOnLayers(
            add_on_type, backbone_channels or spec.feature_depth,
            spec.proto_depth, bottleneck_stride, dtype)
        self.scale_head = None if scale_head_type is None else \
            ScaleHead(scale_head_type, spec.proto_depth, dtype)
        self.kernel_head = activation_fn == "log" and scale_head_type is None
        self._head = WeightCache()        # fast_logits' head, built once
        self.prototype_vectors = nn.Parameter(torch.rand(
            spec.num_prototypes, spec.proto_depth, 1, 1, generator=generator))
        identity = spec.class_identity
        c = spec.num_classes
        if grouped:
            if spec.num_groups <= 0:
                raise ValueError("grouped=True requires spec.num_groups > 0")
            g = spec.num_groups
            nonzero = spec.nonempty_classes
            self.group_projection = nn.ModuleList()
            for cls in nonzero:
                lin = nn.Linear(int(spec.class_counts[cls]), g, bias=False)
                draw = torch.rand(lin.weight.shape, generator=generator)
                with torch.no_grad():
                    lin.weight.copy_(group_projection_init(draw * 2.0 - 1.0))
                self.group_projection.append(lin)
            self.last_layer_group = nn.Linear(g * len(nonzero), c, bias=False)
            own = np.zeros((c, g * len(nonzero)), np.float32)
            for k, cls in enumerate(nonzero):
                own[cls, k * g:(k + 1) * g] = 1.0
            packed = own + incorrect_strength * (1.0 - own)
            self.last_layer_group.weight.data.copy_(torch.from_numpy(packed))
            # own-class entries of the packed group last layer
            self.register_buffer("_glw_own", torch.from_numpy(own),
                                 persistent=False)
            # packed -> dense scatter indices (non-persistent: not weights)
            idx = spec.class_proto_index
            slots = np.concatenate([
                cls * idx.shape[1] + np.arange(spec.class_counts[cls])
                for cls in nonzero]) if nonzero else np.zeros(0, np.int64)
            rows = np.asarray([cls * g + j for cls in nonzero
                               for j in range(g)], np.int64)
            self.register_buffer("_gw_slots", torch.as_tensor(slots),
                                 persistent=False)
            self.register_buffer("_glw_rows", torch.as_tensor(rows),
                                 persistent=False)
        else:
            self.last_layer = nn.Linear(spec.num_prototypes, c, bias=False)
            init_w = identity + incorrect_strength * (1.0 - identity)
            self.last_layer.weight.data.copy_(torch.from_numpy(init_w.T))

    # ------------------------------------------------------------------
    # Dense views of the reference-layout parameters
    # ------------------------------------------------------------------
    def prototypes(self) -> torch.Tensor:
        """(P, D) prototype bank."""
        return self.prototype_vectors.flatten(1)

    def group_weights(self):
        """(group_projection (C, G, Pc_max), last_layer_group (C*G, C))."""
        spec = self.spec
        c, g, pc = spec.num_classes, spec.num_groups, \
            spec.max_protos_per_class
        dev = self.prototype_vectors.device
        packed = torch.cat([m.weight for m in self.group_projection], dim=1)
        gw = torch.zeros((c * pc, g), dtype=packed.dtype, device=dev)
        gw[self._gw_slots] = packed.t()
        glw = torch.zeros((c * g, c), dtype=packed.dtype, device=dev)
        glw[self._glw_rows] = self.last_layer_group.weight.t()
        return gw.reshape(c, pc, g).permute(0, 2, 1), glw

    @torch.no_grad()
    def project_group_simplex_(self) -> None:
        """Put every group-projection row back on the simplex, in place
        (the version counters move, so K1's packed head rebuilds)."""
        for m in self.group_projection:
            m.weight.copy_(projection_simplex_sort(m.weight))

    def mask_last_layer_group_grad_(self) -> None:
        """Keep only the own-class entries of the group last layer's
        gradient (the group phase's joint step at incorrect_strength 0)."""
        grad = self.last_layer_group.weight.grad
        if grad is not None:
            grad.mul_(self._glw_own)

    @property
    def aspp(self) -> Optional[nn.Module]:
        """The backbone's ASPP head (None for a backbone without one, the
        plain U-Net)."""
        return getattr(self.features.base, "aspp", None)

    def set_compute_dtype(self, dtype: torch.dtype) -> "PPNet":
        """Training form of mixed precision: parameters stay float32, the
        convs and the add-on compute in ``dtype``; the features then stay
        in ``dtype`` (bf16 takes the block-diagonal distance head) and the
        distances, activations and logits are float32."""
        set_compute_dtype(self.features, dtype)
        self.add_on_layers.dtype = dtype
        if self.scale_head is not None:
            self.scale_head.dtype = dtype
        self.dtype = dtype
        return self

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def backbone_features(self, x: torch.Tensor, train: bool = False,
                          train_bn: bool = False
                          ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """(B, H, W, 3) -> backbone features (B, S*D, Hp, Wp); with the
        MSC pyramid the fused map, or in training ``[base, *pyramid,
        fused]`` (the pyramid in ``msc_scales`` order, the max taken in
        that order, as the JAX package does).  ``train_bn``: the
        backbone's BN normalizes with batch statistics and updates its
        running ones (``Features``)."""
        base = self.features(x.permute(0, 3, 1, 2), train_bn)
        if not self.msc_scales:
            return base
        pyramid = [self.features(
            resize_bilinear_factor(x, p).permute(0, 3, 1, 2), train_bn)
            for p in self.msc_scales]
        hb, wb = base.shape[2], base.shape[3]
        fused = base
        for f in pyramid:
            up = resize_bilinear(f.permute(0, 2, 3, 1), hb, wb)
            fused = torch.maximum(fused, as_dtype(up.permute(0, 3, 1, 2),
                                                  fused.dtype))
        return [base, *pyramid, fused] if train else fused

    def conv_features(self, x: torch.Tensor, train: bool = False,
                      train_bn: bool = False
                      ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """(B, H, W, 3) -> post-add-on features (B, Hp, Wp, S*D); a list
        of them in training with the MSC pyramid."""
        feats = self.backbone_features(x, train, train_bn)
        if isinstance(feats, list):
            return [self.add_on_layers(f).permute(0, 2, 3, 1) for f in feats]
        return self.add_on_layers(feats).permute(0, 2, 3, 1)

    def compute_group(self, activations: torch.Tensor) -> torch.Tensor:
        """(..., Pa) -> (..., C, G) group activations."""
        gw, _ = self.group_weights()
        return group_activations(activations, gw, self.spec)

    def prototype_distances_from_features(self, f: torch.Tensor
                                          ) -> torch.Tensor:
        """(B, Hp, Wp, S*D) features -> (B, Hp, Wp, Pa) distances; with the
        scale head, scale by scale from the coarsest, each scale's
        features taking in the previous scale's activations (the JAX
        package's loop, the reference's ``model_multiscale.py:299-317``)."""
        spec, protos = self.spec, self.prototypes()
        if self.scale_head is None:
            return scale_l2_distances(f, protos, spec.scale_bounds)
        depth = spec.proto_depth
        outs, prev = {}, None
        for s in range(spec.num_scales - 1, -1, -1):
            lo, hi = spec.scale_bounds[s]
            xs = f[..., s * depth:(s + 1) * depth]
            if prev is not None:
                prev_lo, prev_hi = spec.scale_bounds[s + 1]
                xs = self.scale_head(
                    xs, distance_to_similarity(prev, self.activation_fn),
                    protos[prev_lo:prev_hi])
            outs[s] = prev = scale_l2_distances(xs, protos[lo:hi],
                                                ((0, hi - lo),))
        return torch.cat([outs[s] for s in range(spec.num_scales)], -1)

    def forward_from_conv_features(self, f: torch.Tensor) -> PPNetOutput:
        distances = self.prototype_distances_from_features(f)
        activations = distance_to_similarity(distances, self.activation_fn)
        if self.grouped:
            group_act = self.compute_group(activations)
            logits = group_act.flatten(-2) @ self.group_weights()[1].float()
        else:
            group_act = None
            w = self.last_layer.weight.t()[:self.spec.num_active_prototypes]
            logits = activations @ w.float()
        return PPNetOutput(logits=logits, distances=distances,
                           activations=activations,
                           group_activations=group_act)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                train_bn: bool = False
                ) -> Union[PPNetOutput, List[PPNetOutput]]:
        """The model's output; ``train`` (default: the module's training
        mode) returns one output per pyramid map, as ``backbone_features``
        lists them, when the model has the MSC pyramid.  ``train_bn``
        trains the backbone's BN (a trainer with ``freeze_type =
        'none'``); the module's mode alone never does."""
        feats = self.conv_features(
            x, self.training if train is None else train, train_bn)
        if isinstance(feats, list):
            return [self.forward_from_conv_features(f) for f in feats]
        return self.forward_from_conv_features(feats)

    def push_forward(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(conv features (B, Hp, Wp, S*D), distances (B, Hp, Wp, Pa)) of
        the fused map: what prototype push scans."""
        f = self.conv_features(x)
        return f, self.prototype_distances_from_features(f)

    def _head_params(self) -> list:
        if self.grouped:
            return [self.prototype_vectors, self.last_layer_group.weight,
                    *self.group_projection.parameters()]
        return [self.prototype_vectors, self.last_layer.weight]

    def _dense_head(self) -> dict:
        """``fused_proto_logits``' dense head weights."""
        if self.grouped:
            gw, glw = self.group_weights()
            return dict(last_layer=None, group_projection=gw,
                        last_layer_group=glw)
        return dict(last_layer=self.last_layer.weight.t())

    def _head_weights(self) -> dict:
        """``fused_proto_logits``' head arguments: the dense weights and
        K1's packed form of them."""
        w = self._dense_head()
        return dict(w, head=pack_head(self.prototypes(), spec=self.spec, **w))

    def packed_buffers(self) -> dict:
        """K1's tables, for ``layers.packed_as_buffers`` (none where the
        head is not the kernel's)."""
        if not self.kernel_head:
            return {}
        head = self._head_weights()["head"]
        if head.bank is None:
            return {}
        return {f"k1_{k}": getattr(head, k) for k in KERNEL_TABLES}

    def fast_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Backbone + add-on, then the fused prototype head (K1) where
        ``kernel_head``, else the plain head.  The head's weights are
        packed once, not per batch."""
        feats = self.conv_features(x).contiguous()
        if not self.kernel_head:
            return self.forward_from_conv_features(feats).logits
        if "k1_bank" in self._buffers:            # held for export
            # the kernel reads only the tables of the packed head
            tables = {k: self._buffers[f"k1_{k}"] for k in KERNEL_TABLES}
            w = dict(self._dense_head(),
                     head=ProtoHead(None, None, None, None, 0, **tables))
        else:
            w = self._head.get(self._head_params(), self._head_weights)
        return fused_proto_logits(feats, self.prototypes(), spec=self.spec,
                                  **w)
