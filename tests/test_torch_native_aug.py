"""The port's native augmentation (``scaleprotoseg_torch/native``).

- ``native.fastaug`` against the JAX package's ``native.fastaug`` on the
  same draws, bit for bit (both build their own copy of ``fastaug.cc``
  with g++).
- The native path against the port's numpy path (``resized_window``,
  flip, normalize) bit for bit: padding (a scale below the window), the
  flip, ``normalize=False``; and whole datasets item by item.
- ``native=False`` and ``SPS_NATIVE_AUG=0`` take the numpy path.
- A build that fails raises with the compiler's complaint; two processes
  that build at once both load a whole library.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from scaleprotoseg_tpu import native as jnative
from scaleprotoseg_torch import native
from scaleprotoseg_torch.constants import conversion_lut, convert_targets
from scaleprotoseg_torch.data.dataset import \
    PatchClassificationDataset as TDataset
from scaleprotoseg_torch.data.dataset import resized_window

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
KW = dict(data_type="cityscapes", mean=MEAN.tolist(), std=STD.tolist(),
          image_margin_size=0, window_size=(33, 49), scales=(0.5, 1.5))


@pytest.fixture(scope="module", autouse=True)
def _jax_build_dir(tmp_path_factory):
    """The JAX package builds its library in place (no temporary name):
    give it a directory of its own, so that another test process building
    it at the same time cannot hand this one a half-written file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPS_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax")))
        yield


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    """4 train images of about 64 x 128, category-index labels 0-34."""
    root = tmp_path_factory.mktemp("city")
    rng = np.random.default_rng(5)
    names = []
    os.makedirs(root / "annotations" / "train")
    os.makedirs(root / "img_with_margin_0" / "train")
    for i, (h, w) in enumerate([(64, 128), (57, 131), (70, 96), (40, 66)]):
        names.append(f"t{i}")
        np.save(root / "annotations" / "train" / f"t{i}.npy",
                rng.integers(0, 35, (h, w)).astype(np.uint8))
        np.save(root / "img_with_margin_0" / "train" / f"t{i}.npy",
                rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    with open(root / "all_images.json", "w") as f:
        json.dump({"train": names}, f)
    return str(root)


def _sample(seed, h=64, w=128):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
            rng.integers(0, 35, (h, w)).astype(np.uint8))


def _numpy_path(image, label, resized, window, start, flip, normalize):
    img, lab = resized_window(image, convert_targets(label, "cityscapes"),
                              resized, start, window, MEAN)
    if flip:
        img, lab = img[:, ::-1], lab[:, ::-1]
    if normalize:
        img = (img - MEAN) / STD
    return img, lab


# scale < window (padding), > 1, exactly 1, with and without flip
CASES = [(0.3, (33, 49), (0, 0), True), (0.5, (40, 40), (0, 17), False),
         (1.0, (64, 128), (0, 0), False), (1.37, (33, 49), (20, 71), True),
         (1.5, (96, 192), (0, 0), True), (0.8, (51, 102), (0, 0), False)]


@pytest.mark.parametrize("scale,window,start,flip", CASES)
def test_fastaug_matches_jax_native(scale, window, start, flip):
    image, label = _sample(1)
    resized = (int(64 * scale), int(128 * scale))
    lut = conversion_lut("cityscapes")
    for normalize in (True, False):
        want = jnative.fastaug(image, label, lut, scale, window, start,
                               flip, MEAN, STD, normalize=normalize)
        got = native.fastaug(image, label, lut, resized, window, start,
                             flip, MEAN, STD, normalize=normalize)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scale,window,start,flip", CASES)
def test_fastaug_matches_numpy_path(scale, window, start, flip):
    image, label = _sample(2)
    resized = (int(64 * scale), int(128 * scale))
    for normalize in (True, False):
        got = native.fastaug(image, label, conversion_lut("cityscapes"),
                             resized, window, start, flip, MEAN, STD,
                             normalize=normalize)
        want = _numpy_path(image, label, resized, window, start, flip,
                           normalize)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_fastaug_refuses_bad_arguments():
    image, label = _sample(3)
    lut = conversion_lut("cityscapes")
    args = ((32, 64), (16, 16), (0, 0), False, MEAN, STD)
    with pytest.raises(ValueError, match="label of shape"):
        native.fastaug(image, label[:-1], lut, *args)
    with pytest.raises(ValueError, match="outside 0-255"):
        native.fastaug(image, label.astype(np.int32) + 250, lut, *args)
    with pytest.raises(ValueError, match="start"):
        native.fastaug(image, label, lut, (32, 64), (16, 16), (-1, 0),
                       False, MEAN, STD)


def test_dataset_items_native_equal_numpy(city_root):
    """Every item of a det_seed dataset, two epochs, native vs numpy."""
    nat = TDataset("train", det_seed=4, root=city_root, **KW)
    ref = TDataset("train", det_seed=4, root=city_root, native=False, **KW)
    assert nat.native and nat.augmentation == "native"
    assert not ref.native and ref.augmentation == "numpy"
    for epoch in (0, 1):
        nat.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(nat)):
            a, b = nat[i], ref[i]
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    # the global stream (no det_seed) draws alike on both paths
    nat.det_seed = ref.det_seed = None
    for seed in range(3):
        random.seed(seed)
        a = nat[1]
        random.seed(seed)
        b = ref[1]
        np.testing.assert_array_equal(a[0], b[0])


def test_opt_outs_take_numpy(city_root, monkeypatch):
    monkeypatch.setenv("SPS_NATIVE_AUG", "0")
    assert not native.native_available()
    for flag in ("auto", True):
        ds = TDataset("train", root=city_root, native=flag, **KW)
        assert not ds.native and ds.augmentation == "numpy"
    monkeypatch.delenv("SPS_NATIVE_AUG")
    assert not TDataset("train", root=city_root, native=False, **KW).native
    assert TDataset("train", root=city_root, **KW).native
    with pytest.raises(ValueError, match="native"):
        TDataset("train", root=city_root, native="yes", **KW)


def test_failed_build_raises(tmp_path, monkeypatch, city_root):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "COMPILER", "/nonexistent/bin/g++")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="cannot build"):
        native.build()
    # a dataset asking for the native path raises too: no quiet numpy
    for flag in ("auto", True):
        with pytest.raises(RuntimeError, match="/nonexistent/bin/g"):
            TDataset("train", root=city_root, native=flag, **KW)
    # a compiler that runs and fails: its stderr is in the error
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "COMPILER", "g++")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="exited 1") as err:
        native.build()
    assert "bad.cc" in str(err.value)
    assert not list((tmp_path / "native").iterdir())


_BUILD_AND_CALL = r"""
import sys
from pathlib import Path
import numpy as np
from scaleprotoseg_torch import native
native.BUILD_DIR = Path(sys.argv[1])
img = np.full((8, 8, 3), 7, np.uint8)
out, lab = native.fastaug(img, np.zeros((8, 8), np.uint8),
                          np.arange(256, dtype=np.uint8), (8, 8), (8, 8),
                          (0, 0), False, [0, 0, 0], [1, 1, 1],
                          normalize=False)
assert np.all(out == np.float32(7) / np.float32(255)), out
print(native.library_path().name)
"""


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Two fresh processes build into one empty directory at once: both
    load and run the library, and only the final file is left."""
    build_dir = tmp_path / "native"
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_CALL,
                               str(build_dir)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(f.name for f in build_dir.iterdir()) == sorted(names)
