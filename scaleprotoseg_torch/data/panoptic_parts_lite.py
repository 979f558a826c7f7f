"""Panoptic-parts uid decoding, the port's copy of the JAX package's
``data/panoptic_parts_lite.py`` (the ``panoptic_parts`` package is not a
dependency).

One integer uid holds up to three fields per pixel
(https://github.com/pmeletis/panoptic_parts):

    uid = sid                             (1-2 digits: semantic only)
    uid = sid * 10^3 + iid                (4-5 digits: + instance)
    uid = sid * 10^5 + iid * 10^2 + pid   (6-7 digits: + part)

with sid in [0, 99], iid in [0, 999], pid in [1, 99]; an absent field
decodes to -1, as ``panoptic_parts.utils.format.decode_uids`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def decode_uids(uids: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(sids, iids, pids) int32 arrays; absent fields are -1."""
    uids = np.asarray(uids, np.int64)
    sids = np.where(uids <= 99, uids,
                    np.where(uids <= 99_999, uids // 1_000,
                             uids // 100_000)).astype(np.int32)
    iids = np.where(uids <= 99, -1,
                    np.where(uids <= 99_999, uids % 1_000,
                             (uids // 100) % 1_000)).astype(np.int32)
    pids = np.where(uids <= 99_999, -1, uids % 100).astype(np.int32)
    return sids, iids, pids
