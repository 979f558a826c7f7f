"""Prototype push (projection) on the card.

The port of the JAX package's ``push/push.py``: every prototype moves
onto the features of its nearest same-class pixel of the train split.

1. A scan over the split, batch by batch: one float32 forward gives the
   distances of every pixel to every prototype; pixels of another class
   (void included) are pushed 1e10 away, and each prototype's minimum and
   its flat pixel index come out per image.  The batch's best image per
   prototype and the running best over the split are folded on the card
   (strict ``<``: the first image wins a tie), so the scan never waits for
   the host.  Bank rows past the last scale bound are +inf and never win.
2. A second pass over the same loader keeps the winner images only; it
   refuses a shuffling loader and checks every batch's blake2b fingerprint
   against the first pass's, so a loader that changed its order cannot
   hand a prototype another image's features.
3. Each unique winner is encoded once, and every prototype it won takes
   the feature vector at its pixel, from its own scale's slice.
4. Exact duplicates among the pushed vectors are pruned (``np.unique``
   over rows, the first of each kept): the spec shrinks and
   ``prune_model_params`` cuts the weights to match.  ``unique_
   prototypes.json`` and ``push_info.npz`` record the outcome.

Precision: the scan and the encoding run the model's float32 forward
with TF32 off and without the K2 kernels, whatever the training recipe
(``float32_forward``), so a pushed prototype sits at distance ~0 from its
pixel, as in the JAX package.

``save_artifacts`` writes the per-prototype images and the bound-box
tables (``push/artifacts.py``) under ``prototypes_dir`` from the winners
of the scan, before the prototypes move, as the JAX package renders them
from its pre-push variables.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from scaleprotoseg_torch.ops.prototype import pad_minima_to_bank
from scaleprotoseg_torch.ops.resize import resize_label_nearest
from scaleprotoseg_torch.spec import ProtoSpec

MAX_DIST = 1e10


@dataclasses.dataclass
class PushResult:
    state_dict: Dict[str, torch.Tensor]  # pushed, pruned to ``spec``
    spec: ProtoSpec                      # the spec after dedup pruning
    kept: np.ndarray                     # indices of the kept prototypes
    winners: np.ndarray                  # (P,) winning image (pre-prune)
    min_dists: np.ndarray                # (P,) winning distance (pre-prune)
    flat_idx: np.ndarray                 # (P,) winning pixel (pre-prune)


@contextlib.contextmanager
def float32_forward(model):
    """The model in eval mode with float32 convs and add-on, the ASPP's
    plain form (no K2) and TF32 off; the training recipe is restored on
    exit."""
    aspp = model.aspp
    saved = (model.dtype, aspp is not None and aspp.fast, model.training,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    model.set_compute_dtype(torch.float32)
    if aspp is not None:
        aspp.fast = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.eval()
    try:
        yield model
    finally:
        dtype, fast, training, tf32_mm, tf32_conv = saved
        if aspp is not None:
            aspp.fast = fast
        model.set_compute_dtype(dtype)
        model.train(training)
        torch.backends.cuda.matmul.allow_tf32 = tf32_mm
        torch.backends.cudnn.allow_tf32 = tf32_conv


def _fingerprint(images) -> tuple:
    a = np.ascontiguousarray(np.asarray(images))
    return (a.shape, str(a.dtype),
            hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest())


def _batch_minima(model, spec: ProtoSpec, class_of_proto: torch.Tensor,
                  images: torch.Tensor, targets: torch.Tensor):
    """Per prototype over a batch: (least masked distance, its image's
    row in the batch, its flat pixel index), all on the device."""
    _, distances = model.push_forward(images)
    h, w = distances.shape[1], distances.shape[2]
    t = resize_label_nearest(targets, h, w).long() - 1
    mask = t[..., None] == class_of_proto
    masked = torch.where(mask, distances, distances + MAX_DIST)
    flat = masked.reshape(masked.shape[0], -1, masked.shape[-1])
    vals, idxs = flat.min(dim=1)                          # (B, Pa)
    vals, idxs = pad_minima_to_bank(vals, idxs, spec)
    best, row = vals.min(dim=0)                           # first row wins
    return best, row, idxs.gather(0, row[None])[0]


def push_prototypes(model, spec: ProtoSpec, push_loader,
                    prototypes_dir: Optional[str] = None,
                    dedup: bool = True, save_artifacts: bool = False,
                    cls2name: Optional[Dict[int, str]] = None,
                    log=print) -> PushResult:
    """Project every prototype of ``model`` (in place) onto its nearest
    same-class pixel of ``push_loader``: re-iterable (images (B, H, W, 3)
    normalized float32, raw labels (B, H, W)) numpy batches of the train
    split in a fixed order.  Returns the pushed state dict pruned of
    duplicates, with the spec it fits; with ``save_artifacts`` and a
    ``prototypes_dir``, the artifacts go there, each class's directory
    named by ``cls2name``."""
    if getattr(push_loader, "shuffle", False):
        raise ValueError(
            "push_prototypes requires a fixed-order loader: the winner "
            "images are collected by running offset on a second pass; pass "
            "a loader with shuffle=False")
    dev = model.prototype_vectors.device
    P = spec.num_prototypes
    class_of_proto = torch.as_tensor(
        np.array(spec.class_ids[:spec.num_active_prototypes], np.int64),
        device=dev)
    best_dist = torch.full((P,), float("inf"), device=dev)
    best_img = torch.full((P,), -1, dtype=torch.long, device=dev)
    best_flat = torch.zeros((P,), dtype=torch.long, device=dev)
    prints: List[tuple] = []
    offset = 0
    with float32_forward(model), torch.no_grad():
        for images, targets in push_loader:
            prints.append(_fingerprint(images))
            vals, row, flat = _batch_minima(
                model, spec, class_of_proto,
                torch.from_numpy(np.asarray(images)).to(dev),
                torch.from_numpy(np.asarray(targets)).to(dev))
            improved = vals < best_dist        # strict: first image wins
            best_dist = torch.where(improved, vals, best_dist)
            best_img = torch.where(improved, offset + row, best_img)
            best_flat = torch.where(improved, flat, best_flat)
            offset += len(images)
        log(f"push: scanned {offset} images in {len(prints)} batches")
        best_dist = best_dist.double().cpu().numpy()
        best_img = best_img.cpu().numpy()
        best_flat = best_flat.cpu().numpy()

        # second pass: keep the winner images only
        winners = set(int(i) for i in np.unique(best_img[best_img >= 0]))
        cache: Dict[int, np.ndarray] = {}
        offset = 0
        for i, (images, _) in enumerate(push_loader):
            if i >= len(prints) or _fingerprint(images) != prints[i]:
                raise RuntimeError(
                    f"push_prototypes: the loader's second pass returned a "
                    f"different batch {i} than the first pass; the loader "
                    "must be re-iterable in a fixed order, or prototype "
                    "vectors would be misassigned")
            for b in range(len(images)):
                if offset + b in winners:
                    cache[offset + b] = np.asarray(images[b])
            offset += len(images)
            if len(cache) == len(winners):
                break

        if save_artifacts and prototypes_dir:
            from scaleprotoseg_torch.push.artifacts import save_push_artifacts
            save_push_artifacts(model, spec, push_loader, best_img, best_flat,
                                prototypes_dir, cls2name=cls2name, log=log)

        matched = best_img >= 0
        if not matched.all():
            log(f"push: WARNING {int((~matched).sum())} prototypes never "
                "matched a class pixel; left unchanged")
        # one encoding per unique winner, every prototype it won gathered
        vectors = model.prototypes().detach().clone()
        depth = spec.proto_depth
        for img in sorted(winners):
            protos = np.nonzero(matched & (best_img == img))[0]
            f = model.conv_features(torch.from_numpy(cache[img][None])
                                    .to(dev))
            f = f.reshape(-1, spec.num_scales, depth)
            vectors[torch.as_tensor(protos, device=dev)] = f[
                torch.as_tensor(best_flat[protos], device=dev),
                torch.as_tensor(spec.scale_ids[protos], device=dev)].float()
        model.prototype_vectors.copy_(vectors.view_as(model.prototype_vectors))

    new_spec, kept = spec, np.arange(P)
    sd = model.state_dict()
    if dedup:
        _, unique = np.unique(vectors.cpu().numpy(), axis=0,
                              return_index=True)
        duplicates = sorted(set(range(P)) - set(int(i) for i in unique))
        if duplicates:
            log(f"push: removing {len(duplicates)} duplicate prototypes")
        new_spec = spec.prune(duplicates)
        kept = spec.keep_indices(duplicates)
        sd = prune_model_params(sd, kept, spec, new_spec)

    if prototypes_dir:
        os.makedirs(prototypes_dir, exist_ok=True)
        with open(os.path.join(prototypes_dir,
                               "unique_prototypes.json"), "w") as f:
            json.dump([int(i) for i in sorted(kept)], f)
        np.savez(os.path.join(prototypes_dir, "push_info.npz"),
                 best_img=best_img, best_flat=best_flat, best_dist=best_dist,
                 kept=kept, scale_ids=spec.scale_ids)
    return PushResult(state_dict=sd, spec=new_spec, kept=kept,
                      winners=best_img, min_dists=best_dist,
                      flat_idx=best_flat)


def prune_model_params(state_dict: Dict[str, torch.Tensor], keep,
                       old_spec: ProtoSpec, new_spec: ProtoSpec
                       ) -> Dict[str, torch.Tensor]:
    """Model surgery for prototype removal: the bank and the last layer's
    input columns keep ``keep``.  Grouped models store one (G, Pc) group
    projection per non-empty class: each keeps its kept prototypes'
    columns (both specs list a class's prototypes in ascending order), a
    class left without prototypes loses its projection, and the group last
    layer loses that class's G input columns (their activations were 0,
    as the JAX package's dense layout zeroes them)."""
    keep = torch.as_tensor(np.asarray(keep), dtype=torch.long)
    out = {k: v for k, v in state_dict.items()
           if not k.startswith("group_projection.")}
    out["prototype_vectors"] = state_dict["prototype_vectors"][
        keep.to(state_dict["prototype_vectors"].device)]
    if "last_layer.weight" in out:
        w = state_dict["last_layer.weight"]
        out["last_layer.weight"] = w[:, keep.to(w.device)]
    if "last_layer_group.weight" not in state_dict:
        return out
    g = old_spec.num_groups
    kept = set(int(i) for i in keep)
    glw = state_dict["last_layer_group.weight"]
    cols, k_new = [], 0
    for k, c in enumerate(old_spec.nonempty_classes):
        if new_spec.class_counts[c] == 0:
            continue
        gp = state_dict[f"group_projection.{k}.weight"]
        old = [j for j, p in enumerate(old_spec.class_proto_index[c])
               if p >= 0 and int(p) in kept]
        out[f"group_projection.{k_new}.weight"] = \
            gp[:, torch.as_tensor(old, device=gp.device)]
        cols += range(k * g, (k + 1) * g)
        k_new += 1
    out["last_layer_group.weight"] = \
        glw[:, torch.as_tensor(cols, dtype=torch.long, device=glw.device)]
    return out
