"""PPNet: the prototype segmentation head over a feature backbone.

Pipeline (the public tensors are NHWC, as in the JAX package):
  backbone -> add-on (sigmoid) -> per-scale L2 prototype distances ->
  log activation -> last linear layer, or per-class group projection +
  exp + group last layer.

Parameters carry the reference's names and layouts, so a state dict from
``checkpoints.convert.ppnet_params_to_statedict`` or the JAX package's
``convert_checkpoint export-torch`` loads with ``strict=True``:
``features.base.*``, ``prototype_vectors`` (P, D, 1, 1),
``last_layer.weight`` (C, P), or per non-empty class
``group_projection.{k}.weight`` (G, Pc) and ``last_layer_group.weight``
(C, G * #non-empty).  ``group_weights`` scatters the packed group weights
into the dense (C, G, Pc_max) / (C*G, C) layouts the head computes with.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from scaleprotoseg_torch.kernels.proto import (fused_proto_logits,
                                               group_activations, pack_head)
from scaleprotoseg_torch.models.layers import WeightCache, set_compute_dtype
from scaleprotoseg_torch.ops.prototype import (distance_to_similarity,
                                               scale_l2_distances)
from scaleprotoseg_torch.spec import ProtoSpec


class PPNetOutput(NamedTuple):
    logits: torch.Tensor                       # (B, Hp, Wp, C)
    distances: torch.Tensor                    # (B, Hp, Wp, Pa)
    activations: torch.Tensor                  # (B, Hp, Wp, Pa)
    group_activations: Optional[torch.Tensor]  # (B, Hp, Wp, C, G) | None


class Features(nn.Module):
    """Holds the backbone as ``base`` (the reference's ``features.base``)."""

    def __init__(self, base: nn.Module):
        super().__init__()
        self.base = base

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.base(x)


class AddOnLayers(nn.Module):
    """Backbone-to-prototype adapter.  Every shipped config uses
    'deeplab_simple', a plain sigmoid, entered in the compute dtype (the
    ASPP hands float32 on); the reference's 1x1-conv stacks
    ('bottleneck', 'regular') are not ported yet."""

    def __init__(self, add_on_type: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        if add_on_type != "deeplab_simple":
            raise NotImplementedError(
                f"add-on {add_on_type!r} is not ported yet")
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x.to(self.dtype))


class PPNet(nn.Module):
    """Prototype segmentation model (single-scale, multi-scale and grouped
    variants of the reference in one module).  The MSC input pyramid and
    the scale head are not part of this port yet."""

    def __init__(self, backbone: nn.Module, spec: ProtoSpec,
                 add_on_type: str = "deeplab_simple",
                 activation_fn: str = "log", grouped: bool = False,
                 incorrect_strength: float = -0.5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.activation_fn = activation_fn
        self.grouped = grouped
        self.dtype = dtype
        self.features = Features(backbone)
        self.add_on_layers = AddOnLayers(add_on_type, dtype)
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
                w = torch.rand(lin.weight.shape, generator=generator) + 1e-3
                lin.weight.data.copy_(w / w.sum(-1, keepdim=True))
                self.group_projection.append(lin)
            self.last_layer_group = nn.Linear(g * len(nonzero), c, bias=False)
            packed = np.full((c, g * len(nonzero)), incorrect_strength,
                             np.float32)
            for k, cls in enumerate(nonzero):
                packed[cls, k * g:(k + 1) * g] = 1.0
            self.last_layer_group.weight.data.copy_(torch.from_numpy(packed))
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

    def set_compute_dtype(self, dtype: torch.dtype) -> "PPNet":
        """Training form of mixed precision: parameters stay float32, the
        convs and the add-on compute in ``dtype``; the features then stay
        in ``dtype`` (bf16 takes the block-diagonal distance head) and the
        distances, activations and logits are float32."""
        set_compute_dtype(self.features, dtype)
        self.add_on_layers.dtype = dtype
        self.dtype = dtype
        return self

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def conv_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> post-add-on features (B, Hp, Wp, S*D)."""
        f = self.features(x.permute(0, 3, 1, 2))
        return self.add_on_layers(f).permute(0, 2, 3, 1)

    def compute_group(self, activations: torch.Tensor) -> torch.Tensor:
        """(..., Pa) -> (..., C, G) group activations."""
        gw, _ = self.group_weights()
        return group_activations(activations, gw, self.spec)

    def forward_from_conv_features(self, f: torch.Tensor) -> PPNetOutput:
        distances = scale_l2_distances(f, self.prototypes(),
                                       self.spec.scale_bounds)
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

    def forward(self, x: torch.Tensor) -> PPNetOutput:
        return self.forward_from_conv_features(self.conv_features(x))

    def _head_params(self) -> list:
        if self.grouped:
            return [self.prototype_vectors, self.last_layer_group.weight,
                    *self.group_projection.parameters()]
        return [self.prototype_vectors, self.last_layer.weight]

    def _head_weights(self) -> dict:
        """``fused_proto_logits``' head arguments: the dense weights and
        K1's packed form of them."""
        if self.grouped:
            gw, glw = self.group_weights()
            w = dict(last_layer=None, group_projection=gw,
                     last_layer_group=glw)
        else:
            w = dict(last_layer=self.last_layer.weight.t())
        return dict(w, head=pack_head(self.prototypes(), spec=self.spec, **w))

    def fast_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Backbone + add-on, then the fused prototype head (K1) when the
        activation is 'log'; other activations take the plain head.  The
        head's weights are packed once, not per batch."""
        feats = self.conv_features(x).contiguous()
        if self.activation_fn != "log":
            return self.forward_from_conv_features(feats).logits
        w = self._head.get(self._head_params(), self._head_weights)
        return fused_proto_logits(feats, self.prototypes(), spec=self.spec,
                                  **w)
