"""The part-intersection pass behind the consistency and stability metrics.

For each (image, present class, class prototype): threshold the
prototype's class-masked activation map, upsampled to the image, at its
quantile; find the connected-component centroids of every part
annotation inside the class; record which parts the thresholded
activation hits at those centroids.  The port of the JAX package's
``analysis/metrics/parts.py``, in two forms with the same rows:

- ``part_intersect``, the device form the CLIs run: for one image and one
  present class, all of the class's prototypes in one batch on the
  distances' device (the activation, cv2's nearest upsample as a gather
  through an index table at the class's pixels, each map's quantile with
  the zeros outside the class counted, the hits gathered at the
  centroids); the host gets one small (prototypes x centroids) tensor a
  class.
- ``part_intersect_plain``, numpy + scipy, map by map as the JAX package
  computes it, with ``scipy.ndimage.label`` in place of cv2's connected
  components.  The tests and ``chip_smoke.py`` hold the device form to it.

Both keep the JAX package's rules: the quantile is taken over the whole
masked map, the zeros outside the class included, and the mask is strictly
above it; every component's centroid counts, and so does label 0's, the
centroid of all pixels outside the part (cv2 reports it, and the JAX
package rounds it half to even and tests it like the others).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import ndimage

from scaleprotoseg_torch.analysis.common import (
    activation_from_distance, activation_from_distance_np, class_protos,
    quantile_map, quantile_rows)

_EIGHT = np.ones((3, 3), bool)     # 8-connectivity, as cv2's


@lru_cache(maxsize=64)
def _cv2_nearest_index(dst: int, src: int) -> np.ndarray:
    """``cv2.resize(..., INTER_NEAREST)``'s source index of each output
    pixel: ``floor(i * (1 / (dst / src)))`` in float64, at most
    ``src - 1``.  ``floor(i * src / dst)`` and ``F.interpolate``'s nearest
    differ from it at some sizes (81 -> 321, 81 -> 513, 63 -> 375)."""
    ifx = 1.0 / (dst / src)
    idx = np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64),
                     src - 1)
    idx.setflags(write=False)
    return idx


def cv2_nearest_index(dst: int, src: int) -> np.ndarray:
    return _cv2_nearest_index(int(dst), int(src))


def resize_nearest_cv2(a: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(a, (width, height), interpolation=INTER_NEAREST)`` of
    an (h, w, ...) array."""
    return a[np.ix_(cv2_nearest_index(height, a.shape[0]),
                    cv2_nearest_index(width, a.shape[1]))]


def component_centroids(ys: np.ndarray, xs: np.ndarray, height: int,
                        width: int) -> np.ndarray:
    """(n, 2) float64 (x, y) centroids of ``cv2.connectedComponentsWith
    Stats`` on the binary (height, width) mask set at (``ys``, ``xs``),
    8-connected: label 0 (every pixel outside the mask; left out when the
    mask covers the image, where cv2 reports NaN) first, then each
    component.  Each is its exact integer coordinate sum over its pixel
    count, as cv2 divides them; the components are labelled inside the
    mask's bounding box, which changes no component."""
    y0, x0 = int(ys.min()), int(xs.min())
    box = np.zeros((int(ys.max()) - y0 + 1, int(xs.max()) - x0 + 1), bool)
    box[ys - y0, xs - x0] = True
    labels, n = ndimage.label(box, structure=_EIGHT)
    lab = labels[ys - y0, xs - x0]
    count = np.bincount(lab, minlength=n + 1)[1:]
    sx = np.bincount(lab, weights=xs, minlength=n + 1)[1:]
    sy = np.bincount(lab, weights=ys, minlength=n + 1)[1:]
    out = np.stack([sx / count, sy / count], axis=1)
    rest = height * width - len(ys)
    if rest:
        bx = width * (width - 1) / 2 * height - float(xs.sum())
        by = height * (height - 1) / 2 * width - float(ys.sum())
        out = np.concatenate([[[bx / rest, by / rest]], out])
    return out


def part_centroids(part_ann: np.ndarray, ys: np.ndarray, xs: np.ndarray
                   ) -> Dict[int, np.ndarray]:
    """{part id > 0 at the class's pixels (``ys``, ``xs``): (n, 2) int
    (x, y) centroids of its pixels there, rounded half to even}."""
    h, w = part_ann.shape
    pv = part_ann[ys, xs]
    out = {}
    for part_id in np.unique(pv):
        if part_id <= 0:
            continue
        sel = pv == part_id
        out[int(part_id)] = np.round(
            component_centroids(ys[sel], xs[sel], h, w)).astype(int)
    return out


def _class_rows(spec, cls_ann, part_ann, filter_proto_ids,
                filter_class_ids):
    """(class id, its prototype ids, its mask, its pixels (ys, xs)) of
    each present class that holds a part pixel (the others have no
    centroids, and no rows).  Class ids are non-negative, so their
    sorted set is ``bincount``'s support."""
    with_parts = np.bincount(cls_ann[part_ann > 0],
                             minlength=int(cls_ann.max()) + 1) > 0
    for class_id in np.flatnonzero(np.bincount(cls_ann.ravel())):
        if class_id == 0 or class_id in filter_class_ids or \
                not with_parts[class_id]:
            continue
        proto_ids = class_protos(spec, class_id - 1)
        if filter_proto_ids is not None:
            proto_ids = [p for p in proto_ids if p in filter_proto_ids]
        y_mask = cls_ann == class_id
        ys, xs = np.nonzero(y_mask)
        yield class_id, proto_ids, y_mask, (ys, xs)


def _row(presence: list, p, class_id, cls2name, img_id) -> list:
    return presence + [int(p), cls2name.get(int(class_id) - 1,
                                            str(class_id - 1)), img_id]


def part_intersect_plain(distances: np.ndarray, cls_ann: np.ndarray,
                         part_ann: np.ndarray, spec,
                         cls2name: Dict[int, str], img_id, quantile: float,
                         max_parts: int,
                         filter_proto_ids: Optional[List[int]] = None,
                         filter_class_ids=(),
                         nan_missing_parts: bool = True) -> List[List]:
    """Rows of [part_0..part_MAX, proto_id, class_name, img_id].

    Args:
      distances: (H', W', P) float32 distance maps of the image.
      cls_ann: (H, W) converted class annotation (0 = void).
      part_ann: (H, W) part ids (``annotations_PIDS``).
      nan_missing_parts: consistency marks a part absent from the class
        NaN, stability 0.
    """
    ih, iw = cls_ann.shape
    rows = []
    for class_id, proto_ids, y_mask, (ys, xs) in _class_rows(
            spec, cls_ann, part_ann, filter_proto_ids, filter_class_ids):
        centroids = part_centroids(part_ann, ys, xs)
        if not centroids:
            continue
        for p in proto_ids:
            presence = [np.nan if nan_missing_parts else 0] * (max_parts + 1)
            act = activation_from_distance_np(distances[:, :, p])
            binary = quantile_map(resize_nearest_cv2(act, ih, iw) * y_mask,
                                  quantile)
            for part_id, cents in centroids.items():
                if part_id > max_parts:
                    continue
                hits = 0
                for x, y in cents:
                    if 0 <= y < ih and 0 <= x < iw:
                        hits += int(binary[y, x, 0])
                presence[part_id] = 0 if hits == 0 else 1
            rows.append(_row(presence, p, class_id, cls2name, img_id))
    return rows


def part_intersect(distances: torch.Tensor, cls_ann: np.ndarray,
                   part_ann: np.ndarray, spec, cls2name: Dict[int, str],
                   img_id, quantile: float, max_parts: int,
                   filter_proto_ids: Optional[List[int]] = None,
                   filter_class_ids=(),
                   nan_missing_parts: bool = True) -> List[List]:
    """``part_intersect_plain``'s rows, each present class's prototypes
    in one batch on ``distances``' device ((H', W', P) float32).  The
    upsampled, masked map is its class's pixels gathered from the logit
    grid through cv2's index table, and the zeros elsewhere, which
    ``quantile_rows`` counts without storing; the hits are the same
    gather at the centroids, times the class mask there."""
    dev = distances.device
    ih, iw = cls_ann.shape
    hp, wp = distances.shape[:2]
    iy, ix = cv2_nearest_index(ih, hp), cv2_nearest_index(iw, wp)
    rows = []
    for class_id, proto_ids, y_mask, (ys, xs) in _class_rows(
            spec, cls_ann, part_ann, filter_proto_ids, filter_class_ids):
        centroids = part_centroids(part_ann, ys, xs)
        if not centroids or not len(proto_ids):
            continue
        counted = {k: c[(c[:, 0] >= 0) & (c[:, 0] < iw) & (c[:, 1] >= 0)
                        & (c[:, 1] < ih)]
                   for k, c in centroids.items() if k <= max_parts}
        pts = np.concatenate([np.zeros((0, 2), int), *counted.values()])
        cells = np.concatenate([iy[ys] * wp + ix[xs],
                                iy[pts[:, 1]] * wp + ix[pts[:, 0]]])
        inside = y_mask[pts[:, 1], pts[:, 0]].astype(np.float32)
        pk = torch.as_tensor(np.asarray(proto_ids, np.int64), device=dev)
        act = activation_from_distance(distances.index_select(2, pk))
        vals = act.reshape(hp * wp, -1).t().index_select(
            1, torch.as_tensor(cells, device=dev))       # (k, pixels + pts)
        thr = quantile_rows(vals[:, :len(ys)], quantile, n=ih * iw)
        at = vals[:, len(ys):] * torch.as_tensor(inside, device=dev)
        hit = (at > thr[:, None]).cpu().numpy()          # (k, n) to the host
        for j, p in enumerate(proto_ids):
            presence = [np.nan if nan_missing_parts else 0] * (max_parts + 1)
            start = 0
            for part_id, cents in counted.items():
                n = len(cents)
                presence[part_id] = int(hit[j, start:start + n].any())
                start += n
            rows.append(_row(presence, p, class_id, cls2name, img_id))
    return rows
