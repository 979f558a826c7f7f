"""Static prototype-bank bookkeeping (numpy only).

The port's own copy of the JAX package's ``ProtoSpec``: prototype->class
and prototype->scale assignment captured in one frozen, hashable record,
plus the derived numpy index tensors the prototype head and the group
projection read.  Same fields, same JSON sidecar schema, so a spec
written next to a checkpoint by either package loads in the other.

Prototype ordering (identical to the reference): scale-major then
class-major; after pruning the layout may be irregular, and the spec
supports any per-prototype ``class_ids`` / ``scale_bounds`` assignment.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProtoSpec:
    """Static description of a prototype bank."""

    num_classes: int
    num_scales: int
    proto_depth: int                      # per-scale feature depth D
    class_ids: Tuple[int, ...]            # per-prototype class id, length P
    scale_bounds: Tuple[Tuple[int, int], ...]  # per-scale (start, end) ranges
    num_groups: int = 0                   # 0 => no group projection

    def __post_init__(self):
        # Scale bounds tile [0, num_active) contiguously in scale order, so
        # a bank index equals its position in the concatenated distances.
        pos = 0
        for lo, hi in self.scale_bounds:
            if lo != pos or hi < lo:
                raise ValueError(
                    f"scale_bounds must be contiguous ascending from 0, "
                    f"got {self.scale_bounds}")
            pos = hi
        if pos > len(self.class_ids):
            raise ValueError("scale_bounds exceed the prototype bank")
        for p in range(pos, len(self.class_ids)):
            if self.class_ids[p] >= 0:
                raise ValueError(
                    f"prototype {p} has class {self.class_ids[p]} but lies "
                    f"outside every scale bound (active count {pos})")

    @classmethod
    def equal_allocation(cls, num_prototypes: int, proto_depth: int,
                         num_classes: int, num_scales: int = 4,
                         num_groups: int = 0) -> "ProtoSpec":
        """Equal per-class per-scale allocation with the reference's floor
        division: prototypes past ``S * C * (P // C // S)`` get class -1."""
        per_scale = num_prototypes // num_scales
        per_class_scale = num_prototypes // num_classes // num_scales
        class_ids = [-1] * num_prototypes
        for s in range(num_scales):
            for c in range(num_classes):
                start = s * per_scale + c * per_class_scale
                for p in range(start, start + per_class_scale):
                    if p < num_prototypes:
                        class_ids[p] = c
        scale_bounds = tuple(
            (s * per_scale, (s + 1) * per_scale) for s in range(num_scales))
        return cls(num_classes=num_classes, num_scales=num_scales,
                   proto_depth=proto_depth, class_ids=tuple(class_ids),
                   scale_bounds=scale_bounds, num_groups=num_groups)

    # ------------------------------------------------------------------
    # JSON sidecar (the ``spec`` entry of ``<checkpoint>.json``)
    # ------------------------------------------------------------------
    def to_meta(self) -> Dict[str, Any]:
        return {
            "num_classes": self.num_classes,
            "num_scales": self.num_scales,
            "proto_depth": self.proto_depth,
            "num_groups": self.num_groups,
            "class_ids": list(self.class_ids),
            "scale_bounds": [list(b) for b in self.scale_bounds],
        }

    @classmethod
    def from_meta(cls, meta: Dict[str, Any]) -> "ProtoSpec":
        return cls(num_classes=meta["num_classes"],
                   num_scales=meta["num_scales"],
                   proto_depth=meta["proto_depth"],
                   num_groups=meta["num_groups"],
                   class_ids=tuple(meta["class_ids"]),
                   scale_bounds=tuple(tuple(b) for b in meta["scale_bounds"]))

    # ------------------------------------------------------------------
    # Basic properties
    # ------------------------------------------------------------------
    @property
    def num_prototypes(self) -> int:
        return len(self.class_ids)

    @property
    def num_active_prototypes(self) -> int:
        """Prototypes covered by the scale bounds: the width of the
        distance/activation tensors (the bank may carry a dangling tail)."""
        return self.scale_bounds[-1][1] if self.scale_bounds else 0

    @property
    def feature_depth(self) -> int:
        """Total backbone channel count (S * D)."""
        return self.num_scales * self.proto_depth

    # ------------------------------------------------------------------
    # Derived index tensors
    # ------------------------------------------------------------------
    @functools.cached_property
    def class_identity(self) -> np.ndarray:
        """One-hot (P, C) float32."""
        out = np.zeros((self.num_prototypes, self.num_classes), np.float32)
        for p, c in enumerate(self.class_ids):
            if c >= 0:
                out[p, c] = 1.0
        return out

    @functools.cached_property
    def class_counts(self) -> np.ndarray:
        """(C,) number of prototypes per class."""
        return self.class_identity.sum(axis=0).astype(np.int32)

    @property
    def max_protos_per_class(self) -> int:
        return int(self.class_counts.max()) if self.num_prototypes else 0

    @property
    def nonempty_classes(self) -> Tuple[int, ...]:
        """Classes that own at least one prototype, ascending (the
        reference packs its group weights over exactly these)."""
        return tuple(int(c) for c in np.nonzero(self.class_counts)[0])

    @functools.cached_property
    def class_proto_index(self) -> np.ndarray:
        """(C, Pc_max) int32 prototype indices per class, ascending, -1 pad."""
        out = np.full((self.num_classes, self.max_protos_per_class), -1,
                      np.int32)
        for c in range(self.num_classes):
            idx = np.nonzero(self.class_identity[:, c])[0]
            out[c, :len(idx)] = idx
        return out

    @functools.cached_property
    def class_proto_onehot(self) -> np.ndarray:
        """(C, Pc_max, Pa) float32 one-hot selection of
        ``class_proto_index`` over the distance layout (width
        ``num_active_prototypes``)."""
        idx = self.class_proto_index
        out = np.zeros(idx.shape + (self.num_active_prototypes,), np.float32)
        c, q = np.nonzero(idx >= 0)
        out[c, q, idx[c, q]] = 1.0
        return out

    @functools.cached_property
    def class_proto_mask(self) -> np.ndarray:
        """(C, Pc_max) float32 validity mask of ``class_proto_index``."""
        return (self.class_proto_index >= 0).astype(np.float32)

    @functools.cached_property
    def class_scale_proto_index(self) -> np.ndarray:
        """(C, S, k_max) int32 prototype indices per (class, scale), -1
        pad."""
        per = {(c, s): [p for p in range(lo, hi) if self.class_ids[p] == c]
               for c in range(self.num_classes)
               for s, (lo, hi) in enumerate(self.scale_bounds)}
        k = max([len(v) for v in per.values()] + [1])
        out = np.full((self.num_classes, self.num_scales, k), -1, np.int32)
        for (c, s), idx in per.items():
            out[c, s, :len(idx)] = idx
        return out

    @functools.cached_property
    def class_scale_proto_mask(self) -> np.ndarray:
        """(C, S, k_max) float32 validity mask of the above."""
        return (self.class_scale_proto_index >= 0).astype(np.float32)

    @functools.cached_property
    def class_scale_proto_onehot(self) -> np.ndarray:
        """(C, S, k_max, Pa) float32 one-hot selection of
        ``class_scale_proto_index`` over the distance layout."""
        idx = self.class_scale_proto_index
        out = np.zeros(idx.shape + (self.num_active_prototypes,), np.float32)
        c, s, k = np.nonzero(idx >= 0)
        out[c, s, k, idx[c, s, k]] = 1.0
        return out

    @functools.cached_property
    def class_scale_counts(self) -> np.ndarray:
        """(C, S) int32 prototype counts per (class, scale)."""
        return self.class_scale_proto_mask.sum(axis=-1).astype(np.int32)

    @functools.cached_property
    def class_has_protos(self) -> np.ndarray:
        """(C,) float32, 1 where the class owns at least one prototype."""
        return (self.class_counts > 0).astype(np.float32)
