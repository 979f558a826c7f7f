"""Normalization constants and the Cityscapes label-ID conversion.

Labels follow the whole package's convention: **0 = void**, class ``c``
is stored as ``c + 1``; losses and evaluation subtract 1.  The
preprocessed Cityscapes ``.npy`` annotations hold category indices (the
official label ids 0-33 with the void ids merged, then license plate);
``convert_targets`` maps them to 1 + the 19-class train id.  Pascal
VOC-2012 stores its raw ids (0-20, 255 void) and converts online too
(``PASCAL_ID_MAPPING``: k -> k + 1, 255 -> 0).  COCO-Stuff's stored ids
are final (``COCO_LUT`` is applied offline, when the dataset is
preprocessed), and so are ADE20K's (0 void, class c stored as c + 1, the
150 classes of ``ADE20K_LABELS``) and EM's (ISBI-2012: the grayscale
label values mapped by ``EM_RGB_2_ID`` offline, 1 background, 2 cell), so
their online conversion is the identity, as in the JAX package.  The
evaluation reads COCO-Stuff, ADE20K and EM labels as they are stored and
names their classes with the tables below.
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

# Pascal VOC-2012: raw id k -> k + 1, 255 -> 0 void.
PASCAL_ID_MAPPING = {255: 0, **{k: k + 1 for k in range(21)}}

PASCAL_CATEGORIES = ["void", "__background__"] + [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# The part metrics (``analysis/metrics``): the largest part id counted, and
# the Pascal class ids (stored, 1 + raw id) they leave out.
MAX_PARTS_CITY = 5
MAX_PARTS_PASCAL = 24
PASCAL_FILTER_CLASS = [1, 5, 10, 11, 19]


# ADE20K (SceneParsing, 150 classes): class c is stored as c + 1, 0 is void
ADE20K_LABELS = [
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper", "fireplace",
    "refrigerator", "grandstand", "path", "stairs", "runway", "case",
    "pool table", "pillow", "screen door", "stairway", "river", "bridge",
    "bookcase", "blind", "coffee table", "toilet", "flower", "book", "hill",
    "bench", "countertop", "stove", "palm", "kitchen island", "computer",
    "swivel chair", "boat", "bar", "arcade machine", "hovel", "bus", "towel",
    "light", "truck", "tower", "chandelier", "awning", "streetlight",
    "booth", "television receiver", "airplane", "dirt track", "apparel",
    "pole", "land", "bannister", "escalator", "ottoman", "bottle", "buffet",
    "poster", "stage", "van", "ship", "fountain", "conveyer belt", "canopy",
    "washer", "plaything", "swimming pool", "stool", "barrel", "basket",
    "waterfall", "tent", "bag", "minibike", "cradle", "oven", "ball", "food",
    "step", "tank", "trade name", "microwave", "pot", "animal", "bicycle",
    "lake", "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce",
    "vase", "traffic light", "tray", "ashcan", "fan", "pier", "crt screen",
    "plate", "monitor", "bulletin board", "shower", "radiator", "glass",
    "clock", "flag",
]
ADE20k_ID_2_LABEL = dict(enumerate(ADE20K_LABELS))


# COCO-Stuff: raw id k is class k (stored as k + 1, 255 -> 0 void)
COCO_ID_MAPPING = {**{i: i + 1 for i in range(182)}, 255: 0}

COCO_LABELS = [
    # 80 "things" (ids 0-89 in the original paper numbering incl. gaps kept
    # as named placeholders) + 91 "stuff"
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "street sign",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "hat",
    "backpack", "umbrella", "shoe", "eye glasses", "handbag", "tie",
    "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "plate", "wine glass", "cup", "fork", "knife",
    "spoon", "bowl", "banana", "apple", "sandwich", "orange", "broccoli",
    "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "mirror", "dining table", "window", "desk",
    "toilet", "door", "tv", "laptop", "mouse", "remote", "keyboard",
    "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator",
    "blender", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush", "hair brush", "banner", "blanket", "branch",
    "bridge", "building-other", "bush", "cabinet", "cage", "cardboard",
    "carpet", "ceiling-other", "ceiling-tile", "cloth", "clothes", "clouds",
    "counter", "cupboard", "curtain", "desk-stuff", "dirt", "door-stuff",
    "fence", "floor-marble", "floor-other", "floor-stone", "floor-tile",
    "floor-wood", "flower", "fog", "food-other", "fruit", "furniture-other",
    "grass", "gravel", "ground-other", "hill", "house", "leaves", "light",
    "mat", "metal", "mirror-stuff", "moss", "mountain", "mud", "napkin",
    "net", "paper", "pavement", "pillow", "plant-other", "plastic",
    "platform", "playingfield", "railing", "railroad", "river", "road",
    "rock", "roof", "rug", "salad", "sand", "sea", "shelf", "sky-other",
    "skyscraper", "snow", "solid-other", "stairs", "stone", "straw",
    "structural-other", "table", "tent", "textile-other", "towel", "tree",
    "vegetable", "wall-brick", "wall-concrete", "wall-other", "wall-panel",
    "wall-stone", "wall-tile", "wall-wood", "water-other", "waterdrops",
    "window-blind", "window-other", "wood",
]
COCO_ID_2_LABEL = dict(enumerate(COCO_LABELS))

# EM / ISBI-2012: the validation frames held out of the 30 training ones,
# the grayscale label value -> label (0 reserved for void), the classes
EM_VAL_SIZE = 10
EM_RGB_2_ID = {0: 1, 255: 2}
EM_ID_2_LABEL = {0: "background", 1: "cell"}
CLASS_WEIGHTS = [1.0, 1.0]


def mapping_to_lut(mapping: dict, size: int = 256,
                   dtype=np.uint8) -> np.ndarray:
    """Dense lookup table from ``{input_id: output_id}``; unmapped ids
    pass through, negative keys land at ``size + key``."""
    lut = np.arange(size, dtype=np.int64)
    for k, v in mapping.items():
        lut[k % size] = v
    return lut.astype(dtype)


CITYSCAPES_19_LUT = mapping_to_lut(CITYSCAPES_19_EVAL_CATEGORIES, size=256)
PASCAL_LUT = mapping_to_lut(PASCAL_ID_MAPPING, size=256)
# applied offline (the preprocessing), never online
COCO_LUT = mapping_to_lut(COCO_ID_MAPPING, size=256)
IDENTITY_LUT = np.arange(256, dtype=np.uint8)
_LUTS = {"cityscapes": CITYSCAPES_19_LUT, "pascal": PASCAL_LUT,
         "coco": IDENTITY_LUT, "ade": IDENTITY_LUT, "em": IDENTITY_LUT}


def conversion_lut(data_type: str) -> np.ndarray:
    """The 256-entry online label conversion of a dataset (the identity
    for COCO-Stuff, ADE20K and EM, whose stored ids are final)."""
    if data_type in _LUTS:
        return _LUTS[data_type]
    raise NotImplementedError(
        f"data type {data_type!r} is not ported yet; the port reads "
        f"{sorted(_LUTS)}")


def convert_targets(targets: np.ndarray, data_type: str) -> np.ndarray:
    """Stored annotation -> labels (0 = void, class c as c + 1);
    COCO-Stuff's, ADE20K's and EM's stored ids pass through unchanged."""
    lut = conversion_lut(data_type)
    return targets if lut is IDENTITY_LUT else lut[targets]
