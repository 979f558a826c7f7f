"""Color jitter (``scaleprotoseg_torch/data/jitter.py``) against OpenCV and
the JAX package.

- The numpy HSV pair against ``cv2.cvtColor`` (cv2 is imported here only;
  the port has none): S and V bit-equal, H bit-equal outside the last 16
  columns of each row and within one float32 rounding at 256-512 (3.1e-5
  degrees) there, where OpenCV runs its scalar formula; the inverse
  bit-equal outside those columns, within one rounding of [0, 1] in them.
- ``color_jitter`` against the JAX package's ``_color_jitter`` on the same
  [0, 1] image and the same ``random.Random`` state, within 1e-5.
- A jittered ``det_seed`` item against the JAX dataset with
  ``jitter=True``: the same draws (scale, crop, flip, then the four
  factors), labels equal, the image's mean error within
  ``test_torch_loader``'s bound for the resize, and within 1e-5 of the
  JAX item when the JAX dataset resizes as the port does; on the native
  dataset too (jittered items take numpy).
- ``is_eval`` and push items are never jittered.
"""

import json
import os
import random

import cv2
import numpy as np
import pytest

from scaleprotoseg_tpu.data import dataset as jdataset_module
from scaleprotoseg_tpu.data.dataset import \
    PatchClassificationDataset as JDataset
from scaleprotoseg_torch.data.dataset import \
    PatchClassificationDataset as TDataset
from scaleprotoseg_torch.data.dataset import resized_window
from scaleprotoseg_torch.data.jitter import (color_jitter, hsv_to_rgb,
                                             jitter_draws, rgb_to_hsv)

WINDOW = (33, 41)
KW = dict(data_type="cityscapes", mean=[0.485, 0.456, 0.406],
          std=[0.229, 0.224, 0.225], image_margin_size=0,
          window_size=WINDOW, scales=(0.5, 1.5))
TAIL = 16           # OpenCV's widest vector (AVX-512, 16 float lanes)
HUE_ULP = 3.0517578e-05


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    """3 train and 2 val images of about 64 x 128, labels 0-34."""
    root = tmp_path_factory.mktemp("city")
    rng = np.random.default_rng(21)
    index = {}
    for split, n in (("train", 3), ("val", 2)):
        os.makedirs(root / "annotations" / split)
        os.makedirs(root / "img_with_margin_0" / split)
        index[split] = []
        for i in range(n):
            h, w = 60 + 5 * i, 120 + 9 * i
            name = f"{split}{i}"
            index[split].append(name)
            np.save(root / "annotations" / split / f"{name}.npy",
                    rng.integers(0, 35, (h, w)).astype(np.uint8))
            np.save(root / "img_with_margin_0" / split / f"{name}.npy",
                    rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    with open(root / "all_images.json", "w") as f:
        json.dump(index, f)
    return str(root)


def _rgb(seed, shape=(96, 203)):
    """[0, 1] float32 RGB with the cases the jitter makes: clipped 0 and
    1, two or three equal channels, grey."""
    rng = np.random.default_rng(seed)
    img = rng.random((*shape, 3), dtype=np.float32)
    img[:10] = np.clip(img[:10] * 1.6 - 0.3, 0, 1)
    img[10:20, :, 1] = img[10:20, :, 0]
    img[20:30, :, 2] = img[20:30, :, 0]
    img[30:40, :, 2] = img[30:40, :, 1]
    img[40:50] = img[40:50, :, :1]
    img[50:55] = 0
    return img


@pytest.mark.parametrize("width", [203, 256, 513])
def test_rgb_to_hsv_against_cv2(width):
    img = _rgb(width, (120, width))
    want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    got = rgb_to_hsv(img)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
    np.testing.assert_array_equal(got[:, :width - TAIL],
                                  want[:, :width - TAIL])
    assert np.abs(got - want).max() <= HUE_ULP


@pytest.mark.parametrize("width", [203, 256, 513])
def test_hsv_to_rgb_against_cv2(width):
    hsv = cv2.cvtColor(_rgb(width + 1, (120, width)), cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0] + np.float32(47.3)) % np.float32(360)
    hsv[60:70, :, 0] = (np.arange(width) % 7 * 60).astype(np.float32)
    hsv[70:75, :, 0] = np.float32(359.99997)
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    got = hsv_to_rgb(hsv)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got[:, :width - TAIL],
                                  want[:, :width - TAIL])
    assert np.abs(got - want).max() <= 1.2e-7


def test_color_jitter_matches_jax():
    """The JAX method is called unbound: it reads nothing of ``self``."""
    for seed in range(8):
        img = _rgb(100 + seed, (65, 97))
        want = JDataset._color_jitter(None, img.copy(),
                                      random.Random(seed))
        r = random.Random(seed)
        got = color_jitter(img, jitter_draws(r))
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5, seed


def _float_resize(image, size, interpolation=None):
    """The port's float bilinear resize (uint8 in, the [0, 1] values x
    255 out) in the place of cv2's fixed-point one, for ``cv2.resize``."""
    w, h = size
    out, _ = resized_window(image, np.zeros(image.shape[:2], np.int32),
                            (h, w), (0, 0), (h, w), (0.0, 0.0, 0.0))
    return out * np.float32(255.0)


@pytest.mark.parametrize("native", [False, "auto"])
def test_jittered_items_match_jax(city_root, native, monkeypatch):
    """Against the JAX dataset as it is: the same draws, equal labels,
    the image's mean error within the resize's bound (the jitter scales
    the cv2-vs-float resize difference up to ~3x, so the largest one is
    held below, not here).  Then against the JAX dataset with cv2's resize
    swapped for the port's: the item within 1e-5 on the [0, 1] scale."""
    jds = JDataset("train", is_eval=False, native=False, jitter=True,
                   det_seed=7, root=city_root, **KW)
    tds = TDataset("train", jitter=True, det_seed=7, native=native,
                   root=city_root, **KW)
    assert tds.augmentation == "numpy+jitter"
    plain = TDataset("train", det_seed=7, native=False, root=city_root,
                     **KW)
    std = np.asarray(KW["std"], np.float32)
    seen = []
    jitter = jds._color_jitter

    def recording(image, r):
        seen.append(r.getstate())
        return jitter(image, r)

    jds._color_jitter = recording
    for epoch in (0, 3):
        for ds in (jds, tds, plain):
            ds.set_epoch(epoch)
        for i in range(len(tds)):
            random.seed(i)          # the global stream must not matter
            want_img, want_lab = jds[i]
            random.seed(1000 + i)
            got_img, got_lab = tds[i]
            # the jitter's draws follow scale, crop and flip on the
            # item's stream
            label = np.load(os.path.join(tds.annotations_dir,
                                         tds.img_ids[i] + ".npy"))
            r = tds.stream(i)
            tds.draw(i, label.shape, WINDOW, r)
            assert r.getstate() == seen[-1]
            np.testing.assert_array_equal(got_lab, want_lab)
            assert np.abs(got_img - want_img).mean() < 8e-3, (epoch, i)
            # and the jitter changed the image
            assert np.abs(got_img - plain[i][0]).mean() > 1e-3
            with monkeypatch.context() as mp:
                mp.setattr(jdataset_module.cv2, "resize", _float_resize)
                same_resize, _ = jds[i]
            err = np.abs(got_img - same_resize) * std
            assert err.max() <= 1e-5, (epoch, i, err.max())


def test_eval_and_push_items_are_not_jittered(city_root):
    for split in ("train", "val"):
        jit = TDataset(split, jitter=True, is_eval=True, det_seed=3,
                       root=city_root, **KW)
        ref = TDataset(split, is_eval=True, det_seed=3, root=city_root,
                       **KW)
        assert jit.augmentation == ref.augmentation == "native"
        for i in range(len(jit)):
            np.testing.assert_array_equal(jit[i][0], ref[i][0])
    jit = TDataset("train", jitter=True, push_prototypes=True,
                   root=city_root, **KW)
    ref = TDataset("train", push_prototypes=True, root=city_root, **KW)
    for i in range(len(jit)):
        np.testing.assert_array_equal(jit[i][0], ref[i][0])
        np.testing.assert_array_equal(jit[i][1], ref[i][1])
