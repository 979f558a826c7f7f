"""Pascal VOC-2012 (aug) in the port against the JAX package.

- ``PASCAL_ID_MAPPING`` / ``PASCAL_LUT`` / ``PASCAL_CATEGORIES``, the
  dataset's online conversion and ``eval_test --pascal``'s reverse LUT
  equal to the JAX package's.
- The port's ``scaleproto_pascal``, ``group_scaleproto_pascal`` and
  ``baseline_pascal`` copies hold the JAX files' bindings, binding for
  binding (only the recipe comment differs); each builds the pyramid
  ``(0.5, 0.75)`` and the JAX package's spec (252 prototypes over 4
  scales, 21 classes, 3 groups; 210 over 1).
- Native and numpy augmentation of the port and the JAX package's native
  one bit-equal on Pascal-sized images at the 321 x 321 window, crops
  smaller than the window among them (the JAX package's numpy path
  resizes with cv2's fixed-point arithmetic: its labels are equal).

Pascal's evaluation and test export against the JAX package are in
``test_torch_pascal_eval.py``, the CLIs on the CPU in
``test_torch_pascal_cli.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from scaleprotoseg_tpu import configlib as jconfiglib
from scaleprotoseg_tpu import constants as jconstants
from scaleprotoseg_tpu import eval_valid_multiscale as jeval
from scaleprotoseg_tpu.data.dataset import \
    PatchClassificationDataset as JDataset
from scaleprotoseg_tpu.models import factory as jfactory
from scaleprotoseg_torch import configlib, constants
from scaleprotoseg_torch import eval_test as teval_test
from scaleprotoseg_torch import eval_valid_multiscale as teval
from scaleprotoseg_torch.cli_common import CONFIGS_DIR
from scaleprotoseg_torch.data.dataset import \
    PatchClassificationDataset as TDataset
from scaleprotoseg_torch.models.factory import construct_ppnet
from torch_parity import port_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "scaleprotoseg_tpu", "configs")
CONFIGS = ("scaleproto_pascal", "group_scaleproto_pascal",
           "baseline_pascal")
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(n)


def pascal_label(rng, h: int, w: int) -> np.ndarray:
    """Raw Pascal ids: a 3 x 4 grid of seeded classes (0-20) inside a
    255 (void) border of 2 pixels."""
    grid = rng.integers(0, 21, (3, 4)).astype(np.uint8)
    label = np.repeat(np.repeat(grid, -(-h // 3), 0), -(-w // 4), 1)[:h, :w]
    label = np.ascontiguousarray(label)
    label[:2], label[-2:], label[:, :2], label[:, -2:] = 255, 255, 255, 255
    return label


def write_pascal_root(root: str, splits: dict, seed: int = 0) -> str:
    """Pascal's preprocessed layout: ``{split: [(h, w), ...]}`` of uint8
    images (a seeded colour per class plus noise) and raw-id labels;
    ``test`` gets images only."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(40, 216, (256, 3)).astype(np.int16)
    index = {}
    for split, sizes in splits.items():
        img_dir = os.path.join(root, "img_with_margin_0", split)
        ann_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)
        index[split] = []
        for i, (h, w) in enumerate(sizes):
            name = f"{split}_{i:03d}"
            index[split].append(name)
            label = pascal_label(rng, h, w)
            noise = rng.integers(-24, 25, (h, w, 3))
            np.save(os.path.join(img_dir, name + ".npy"),
                    np.clip(palette[label] + noise, 0, 255).astype(np.uint8))
            if split != "test":
                np.save(os.path.join(ann_dir, name + ".npy"), label)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


def test_pascal_tables_match_jax():
    assert constants.PASCAL_ID_MAPPING == jconstants.PASCAL_ID_MAPPING
    assert constants.PASCAL_CATEGORIES == jconstants.PASCAL_CATEGORIES
    np.testing.assert_array_equal(constants.PASCAL_LUT, jconstants.PASCAL_LUT)
    np.testing.assert_array_equal(constants.conversion_lut("pascal"),
                                  jconstants.conversion_lut("pascal"))
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(constants.convert_targets(raw, "pascal"),
                                  jconstants.convert_targets(raw, "pascal"))
    from scaleprotoseg_tpu import eval_test as jeval_test
    np.testing.assert_array_equal(teval_test.train_id_to_source_lut(True),
                                  jeval_test.train_id_to_source_lut(True))
    assert teval.class_names("pascal", 21) == jeval.class_names("pascal", 21)


@pytest.mark.parametrize("name", CONFIGS)
def test_pascal_config_matches_jax(name):
    ours = configlib.parse_config_file(os.path.join(CONFIGS_DIR,
                                                    name + ".gin"))
    assert ours == configlib.parse_config_file(
        os.path.join(JAX_CONFIGS, name + ".gin"))
    dataset = ours["PatchClassificationDataset"]
    assert ours["PatchClassificationDataModule"]["train_key"] == "train_aug"
    assert dataset["only_19_from_cityscapes"] is False
    assert dataset["window_size"] == (321, 321)
    assert dataset["scales"] == (0.5, 1.5)
    with open(os.path.join(CONFIGS_DIR, name + ".gin")) as f:
        text = f.read()
    assert "GPU training recipe" in text and "TPU" not in text


@pytest.mark.parametrize("name,variant,layout", [
    ("scaleproto_pascal", "multiscale", (252, 21, 4, 0)),
    ("group_scaleproto_pascal", "group", (252, 21, 4, 3)),
    ("baseline_pascal", "single", (210, 21, 1, 0))])
def test_pascal_config_builds_the_jax_spec(name, variant, layout):
    bindings = configlib.parse_config_file(os.path.join(CONFIGS_DIR,
                                                        name + ".gin"))
    cname = "construct_PPNet_Group" if variant == "group" else \
        "construct_PPNet"
    q = bindings[cname]
    model, spec = construct_ppnet(
        variant, q["base_architecture"], tuple(q["prototype_shape"]),
        q["num_classes"], bindings=bindings)
    jconfiglib.clear_config()
    try:
        jconfiglib.parse_config_file(os.path.join(JAX_CONFIGS, name + ".gin"))
        jmodel, jspec = jfactory.construct_PPNet_Group() \
            if variant == "group" else jfactory.construct_PPNet(variant)
    finally:
        jconfiglib.clear_config()
    assert model.msc_scales == tuple(jmodel.msc_scales) == (0.5, 0.75)
    assert (spec.num_prototypes, spec.num_classes, spec.num_scales,
            spec.num_groups) == layout
    assert spec == port_spec(jspec)
    assert model.features.base.aspp.mode == \
        ("sum" if variant == "single" else "concat")


# ---------------------------------------------------------------------------
# augmentation at Pascal's sizes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def _jax_build_dir(tmp_path_factory):
    """The JAX package builds its native library in place: a directory of
    its own for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPS_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax")))
        yield


def test_pascal_augmentation_native_numpy_jax_equal(tmp_path_factory,
                                                    _jax_build_dir):
    """Items of Pascal-sized images (500 x 375, 375 x 500, 333 x 500) at
    the 321 window and scales (0.5, 1.5), three epochs of ``det_seed``
    draws: the port's native and numpy paths and the JAX package's native
    path give the same bits, and the JAX package's numpy path (cv2 on
    uint8) the same labels; some crops are smaller than the window
    (bottom/right padding)."""
    root = write_pascal_root(
        str(tmp_path_factory.mktemp("pascal_aug")),
        {"train_aug": [(375, 500), (500, 375), (333, 500)]}, seed=8)
    kw = dict(data_type="pascal", mean=MEAN, std=STD, image_margin_size=0,
              window_size=(321, 321), scales=(0.5, 1.5), root=root,
              det_seed=5)
    datasets = {"port native": TDataset("train_aug", native=True, **kw),
                "port numpy": TDataset("train_aug", native=False, **kw),
                "jax native": JDataset("train_aug", is_eval=False,
                                       native=True, **kw)}
    jax_numpy = JDataset("train_aug", is_eval=False, native=False, **kw)
    padded = 0
    for epoch in range(3):
        for ds in (*datasets.values(), jax_numpy):
            ds.set_epoch(epoch)
        for i in range(3):
            label = np.load(os.path.join(root, "annotations", "train_aug",
                                         f"train_aug_{i:03d}.npy"))
            (rh, rw), _, _ = datasets["port numpy"].draw(i, label.shape,
                                                         (321, 321))
            padded += rh < 321 or rw < 321
            want = datasets["jax native"][i]
            for name, ds in datasets.items():
                got = ds[i]
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape, name
                    np.testing.assert_array_equal(g, w, err_msg=name)
            np.testing.assert_array_equal(jax_numpy[i][1], want[1])
            assert set(np.unique(want[1])) <= set(range(22))
    assert padded >= 2
