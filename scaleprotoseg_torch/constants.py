"""Normalization constants and the Cityscapes label-ID conversion.

Labels follow the whole package's convention: **0 = void**, class ``c``
is stored as ``c + 1``; losses and evaluation subtract 1.  The
preprocessed Cityscapes ``.npy`` annotations hold category indices (the
official label ids 0-33 with the void ids merged, then license plate);
``convert_targets`` maps them to 1 + the 19-class train id.  Only
Cityscapes converts here: the other datasets are not part of the port
yet and are refused by name.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Official cityscapesScripts label table, every void-category id merged
# into one leading "void"; the index in CITYSCAPES_CATEGORIES is the
# category index the preprocessed annotations store.
CITYSCAPES_ID_2_LABEL = {
    **{i: "void" for i in range(7)},
    7: "road", 8: "sidewalk", 9: "parking", 10: "rail track", 11: "building",
    12: "wall", 13: "fence", 14: "guard rail", 15: "bridge", 16: "tunnel",
    17: "pole", 18: "polegroup", 19: "traffic light", 20: "traffic sign",
    21: "vegetation", 22: "terrain", 23: "sky", 24: "person", 25: "rider",
    26: "car", 27: "truck", 28: "bus", 29: "caravan", 30: "trailer",
    31: "train", 32: "motorcycle", 33: "bicycle", -1: "license plate",
}

CITYSCAPES_CATEGORIES = ["void"] + [
    CITYSCAPES_ID_2_LABEL[i] for i in range(7, 34)] + ["license plate"]

CITYSCAPES_19_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]
# category index -> 1 + 19-class train id; ignored-in-eval categories -> 0
CITYSCAPES_19_EVAL_CATEGORIES = {
    idx: (CITYSCAPES_19_NAMES.index(name) + 1
          if name in CITYSCAPES_19_NAMES else 0)
    for idx, name in enumerate(CITYSCAPES_CATEGORIES)
}


def mapping_to_lut(mapping: dict, size: int = 256,
                   dtype=np.uint8) -> np.ndarray:
    """Dense lookup table from ``{input_id: output_id}``; unmapped ids
    pass through, negative keys land at ``size + key``."""
    lut = np.arange(size, dtype=np.int64)
    for k, v in mapping.items():
        lut[k % size] = v
    return lut.astype(dtype)


CITYSCAPES_19_LUT = mapping_to_lut(CITYSCAPES_19_EVAL_CATEGORIES, size=256)


def conversion_lut(data_type: str) -> np.ndarray:
    """The 256-entry online label conversion of a dataset."""
    if data_type == "cityscapes":
        return CITYSCAPES_19_LUT
    raise NotImplementedError(
        f"data type {data_type!r} is not ported yet; the port reads "
        "'cityscapes'")


def convert_targets(targets: np.ndarray, data_type: str) -> np.ndarray:
    """Category indices -> labels (0 = void, class c as c + 1)."""
    return conversion_lut(data_type)[targets]
