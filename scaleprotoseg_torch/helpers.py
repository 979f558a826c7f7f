"""Small host-side helpers (parity with reference `helpers.py`)."""

from __future__ import annotations

import os

import numpy as np


def makedir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def list_of_distances(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """All-pairs squared L2 distances (ref helpers.py:10-11)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    return ((x[:, None] - y[None]) ** 2).sum(-1)


def find_high_activation_crop(activation_map: np.ndarray,
                              percentile: float = 95):
    """Tight bbox around the top-percentile activation region
    (ref helpers.py:29-50).  Returns (y0, y1, x0, x1), end-exclusive."""
    threshold = np.percentile(activation_map, percentile)
    mask = activation_map >= threshold
    rows = np.nonzero(mask.any(axis=1))[0]
    cols = np.nonzero(mask.any(axis=0))[0]
    if len(rows) == 0:
        return 0, 1, 0, 1
    return int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1


def find_continuous_high_activation_crop(activation_map: np.ndarray,
                                         patch_bbox, threshold: float,
                                         add_margin: int = 5):
    """Greedily grow the patch bbox while adjacent rows/cols stay above
    threshold (behavioral parity with ref helpers.py:53-87).

    Each sweep tries to advance the four frontiers in the reference's
    order (top, bottom, left, right), one row/column at a time; a
    frontier whose adjacent strip (taken over the CURRENT perpendicular
    extent, inclusive) has no above-threshold pixel retires permanently,
    even if later growth of the other axis would re-expose activation.
    Returns an end-exclusive bbox with ``add_margin`` padding, clamped.
    """
    mask = np.asarray(activation_map) >= threshold
    shape = mask.shape
    # bounds[axis] = [low, high] inclusive; axis 0 = rows, axis 1 = cols
    bounds = [[int(patch_bbox[0]), int(patch_bbox[1])],
              [int(patch_bbox[2]), int(patch_bbox[3])]]
    # frontier = (axis, side); side 0 grows toward 0, side 1 toward the
    # edge.  Sweep order matters: the left/right strips are taken over
    # the row extent ALREADY updated this sweep.
    frontiers = [(0, 0), (0, 1), (1, 0), (1, 1)]
    live = set(frontiers)
    while live:
        for axis, side in frontiers:
            if (axis, side) not in live:
                continue
            nxt = bounds[axis][side] + (1 if side else -1)
            lo, hi = bounds[1 - axis]
            strip = (mask[nxt, lo:hi + 1] if axis == 0
                     else mask[lo:hi + 1, nxt]) \
                if 0 <= nxt < shape[axis] else None
            if strip is not None and strip.any():
                bounds[axis][side] = nxt
            else:
                live.discard((axis, side))
    (r0, r1), (c0, c1) = bounds
    return (max(r0 - add_margin, 0), min(r1 + add_margin, shape[0] - 1) + 1,
            max(c0 - add_margin, 0), min(c1 + add_margin, shape[1] - 1) + 1)
