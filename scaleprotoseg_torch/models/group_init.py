"""Equivariance-JSON initialization of the group projection.

The port's copy of the JAX package's ``models/group_init.py``, on the
port's packed layout (one (G, Pc) ``group_projection.{k}`` weight per
non-empty class).  A JSON maps each class to a list of groups, each group
a per-scale list of prototype indices local to that class within that
scale.  For group row k of class c:

- every listed prototype (offset into the class's columns by the class's
  prototype counts of the scales before) gets ``weight / len(p_ids)`` of
  its scale's list;
- the other entries are rescaled by
  ``(1 - tot_scale * weight) / (1 - tot_org_weight)``, so the row stays
  on the simplex.

The reference's branch that grows a class past ``num_groups`` groups is
refused, as the JAX package refuses it.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from scaleprotoseg_torch.spec import ProtoSpec


def equivariance_class_weights(w: np.ndarray, scale_counts: np.ndarray,
                               groups: List, weight: float) -> np.ndarray:
    """A re-initialized copy of one class's (G, Pc) group weights;
    ``scale_counts`` is the class's (S,) prototype count per scale."""
    w = np.array(w, np.float32)
    offsets = np.concatenate([[0], np.cumsum(scale_counts)[:-1]])
    for k, group in enumerate(groups):
        tot_scale = sum(1 for p_ids in group if len(p_ids) > 0)
        tot_org_weight = 0.0
        cols = []
        for scale, p_ids in enumerate(group):
            if not p_ids:
                continue
            scale_cols = [int(p) + int(offsets[scale]) for p in p_ids]
            cols.extend(scale_cols)
            for col in scale_cols:
                tot_org_weight += float(w[k, col])
                w[k, col] = weight / len(p_ids)
        rest = np.ones(w.shape[-1], bool)
        rest[cols] = False
        w[k, rest] *= (1.0 - tot_scale * weight) / (1.0 - tot_org_weight)
    return w


def apply_equivariance_init(model, spec: ProtoSpec, group_equiv_path: str,
                            weight: float = 0.25, log=print) -> None:
    """Read the JSON (keys: stringified class ids) and re-initialize the
    model's group projections in place."""
    log(f"Running Equivariance Initialization with weight {weight}")
    with open(group_equiv_path) as f:
        group_equiv: Dict[int, List] = {int(k): v
                                        for k, v in json.load(f).items()}
    slot = {c: k for k, c in enumerate(spec.nonempty_classes)}
    for cls, groups in group_equiv.items():
        if len(groups) > spec.num_groups:
            raise NotImplementedError(
                f"class {cls} specifies {len(groups)} equivariance groups > "
                f"num_groups={spec.num_groups}; the reference's group-count "
                "expansion branch is not ported")
        if cls not in slot:
            raise ValueError(f"class {cls} has no prototypes, so no group "
                             "projection to initialize")
        param = model.group_projection[slot[cls]].weight
        new = equivariance_class_weights(param.detach().cpu().numpy(),
                                         spec.class_scale_counts[cls],
                                         groups, weight)
        with torch.no_grad():
            param.copy_(torch.from_numpy(new))
