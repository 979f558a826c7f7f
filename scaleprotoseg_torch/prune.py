"""Prototype pruning by nearest-patch class purity.

The port of the JAX package's ``prune.py``: each prototype's k (= 6)
nearest training patches (``find_nearest``); a prototype with fewer than
``prune_threshold`` (= 3) patches of its own class is pruned.  With a
model directory, ``pruned_prototypes_epoch{e}_k{k}_pt{t}/`` there gets
``prune_info.npy`` ((pruned index, class) int64 rows) and
``prototypes_to_keep.json``.  The surgery is ``ProtoSpec.prune`` and
``push.prune_model_params``: the bank and the last layer's columns, or in
a grouped model each class's group projection, with a class left without
prototypes losing its projection and its group columns.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scaleprotoseg_torch.find_nearest import (
    find_k_nearest_patches_to_prototypes)
from scaleprotoseg_torch.push.push import prune_model_params
from scaleprotoseg_torch.spec import ProtoSpec


def prune_prototypes(push_loader, model, spec: ProtoSpec, k: int = 6,
                     prune_threshold: int = 3,
                     original_model_dir: Optional[str] = None,
                     epoch_number: int = 0, full_save: bool = False,
                     mesh=None, log=print
                     ) -> Tuple[Dict[str, torch.Tensor], ProtoSpec,
                                np.ndarray]:
    """Returns (the pruned state dict, the pruned spec, kept indices)."""
    nearest_class_ids = find_k_nearest_patches_to_prototypes(
        push_loader, model, spec, k=k, full_save=full_save,
        root_dir_for_saving_images=(
            os.path.join(original_model_dir, "img")
            if original_model_dir and full_save else None),
        mesh=mesh, log=log)

    proto_class = np.argmax(spec.class_identity, axis=1)
    to_prune = []
    for j in range(spec.num_prototypes):
        own = int(np.sum(nearest_class_ids[j] == proto_class[j]))
        if own < prune_threshold:
            to_prune.append(j)
    log(f"k = {k}, prune_threshold = {prune_threshold}")
    log(f"{len(to_prune)} prototypes will be pruned")

    if original_model_dir:
        book_dir = os.path.join(
            original_model_dir,
            f"pruned_prototypes_epoch{epoch_number}_k{k}"
            f"_pt{prune_threshold}")
        os.makedirs(book_dir, exist_ok=True)
        prune_info = np.stack(
            [np.asarray(to_prune, np.int64),
             proto_class[to_prune].astype(np.int64)], axis=1) \
            if to_prune else np.zeros((0, 2), np.int64)
        np.save(os.path.join(book_dir, "prune_info.npy"), prune_info)
        keep = [int(i) for i in range(spec.num_prototypes)
                if i not in set(to_prune)]
        with open(os.path.join(book_dir, "prototypes_to_keep.json"),
                  "w") as f:
            json.dump(keep, f)

    new_spec = spec.prune(to_prune)
    keep_idx = spec.keep_indices(to_prune)
    state = prune_model_params(model.state_dict(), keep_idx, old_spec=spec,
                               new_spec=new_spec)
    return state, new_spec, keep_idx
