"""The port's loader bindings and data stream against the JAX package's.

- ``PatchClassificationDataModule.loader_backend``: 'threads' is the
  threaded loader; 'grain' and 'grain_processes' are refused by name
  (``NotImplementedError``), any other value raises the JAX package's
  ``ValueError``, as the JAX package's ``make_loaders`` does.
- ``PatchClassificationDataset.det_seed``: the port draws each item's
  scale, crop start and flip from the same per-(det_seed, epoch, index)
  stream as the JAX package, bit for bit; the labels are bit-equal and the
  images agree within ``test_torch_train_ops``'s bound for the resize (the
  port's is not cv2's fixed-point one).
- ``DataLoader.fast_forward(k)`` lands where a loader that drew ``k``
  batches is, across an epoch boundary, in the JAX loader's index order.
- With ``det_seed`` two threaded iterations give the same bits.
"""

import json
import os
import random

import numpy as np
import pytest

from scaleprotoseg_tpu import cli_common as jcli
from scaleprotoseg_tpu import configlib as jconfig
from scaleprotoseg_tpu.data.dataset import \
    PatchClassificationDataset as JDataset
from scaleprotoseg_tpu.data.loader import DataLoader as JLoader
from scaleprotoseg_torch import cli_common
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.data.dataset import \
    PatchClassificationDataset as TDataset
from scaleprotoseg_torch.data.loader import DataLoader as TLoader

WINDOW = (33, 33)
KW = dict(data_type="cityscapes", mean=[0.485, 0.456, 0.406],
          std=[0.229, 0.224, 0.225], image_margin_size=0,
          window_size=WINDOW, scales=(0.5, 1.5))
BINDINGS = """
PatchClassificationDataset.data_type = 'cityscapes'
PatchClassificationDataset.image_margin_size = 0
PatchClassificationDataset.mean = [0.485, 0.456, 0.406]
PatchClassificationDataset.std = [0.229, 0.224, 0.225]
PatchClassificationDataset.scales = (0.5, 1.5)
PatchClassificationDataset.window_size = (33, 33)
PatchClassificationDataModule.dataloader_n_jobs = 2
"""


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    """Cityscapes layout: 5 train and 2 val images of different sizes,
    category-index labels 0-34."""
    root = tmp_path_factory.mktemp("city")
    rng = np.random.default_rng(11)
    index = {}
    for split, n in (("train", 5), ("val", 2)):
        os.makedirs(root / "annotations" / split)
        os.makedirs(root / "img_with_margin_0" / split)
        index[split] = []
        for i in range(n):
            h, w = 40 + 7 * i, 72 + 11 * i
            name = f"{split}{i}"
            index[split].append(name)
            np.save(root / "annotations" / split / f"{name}.npy",
                    rng.integers(0, 35, (h, w)).astype(np.uint8))
            np.save(root / "img_with_margin_0" / split / f"{name}.npy",
                    rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    with open(root / "all_images.json", "w") as f:
        json.dump(index, f)
    return str(root)


# ---------------------------------------------------------------------------
# loader_backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend,error", [
    ("grain", NotImplementedError), ("grain_processes", NotImplementedError),
    ("bogus", ValueError)])
def test_make_loaders_refuses_unported_backends(city_root, backend, error):
    bindings = parse_config(BINDINGS + "PatchClassificationDataModule."
                            f"loader_backend = '{backend}'\n")
    with pytest.raises(error, match=backend):
        cli_common.make_loaders(bindings, 2, data_root=city_root)


def test_make_loaders_threads_backend_and_det_seed(city_root):
    bindings = parse_config(
        BINDINGS + "PatchClassificationDataModule.loader_backend = "
        "'threads'\nPatchClassificationDataset.det_seed = 5\n")
    tl, vl = cli_common.make_loaders(bindings, 2, seed=3,
                                     data_root=city_root)
    assert isinstance(tl, TLoader) and tl.shuffle and not vl.shuffle
    assert tl.dataset.det_seed == 5 and vl.dataset.det_seed == 5
    assert tl.num_workers == 2 and tl.seed == 3


def test_jax_make_loaders_rejects_bogus_backend(city_root):
    """The JAX package's error, which the port's repeats."""
    jconfig.clear_config()
    try:
        jconfig.parse_config(BINDINGS + "PatchClassificationDataModule."
                             "loader_backend = 'bogus'\n")
        with pytest.raises(ValueError, match="unknown loader_backend "
                           "'bogus'"):
            jcli.make_loaders(2, data_root=city_root)
    finally:
        jconfig.clear_config()


# ---------------------------------------------------------------------------
# det_seed
# ---------------------------------------------------------------------------
def _jax_draws(ds):
    """The JAX dataset with its numpy pipeline's arguments recorded."""
    seen = []
    aug = ds._python_aug

    def recording(image, label, window, scale, resized, start, flip, *rest):
        seen.append((tuple(resized), tuple(start), bool(flip)))
        return aug(image, label, window, scale, resized, start, flip, *rest)

    ds._python_aug = recording
    return seen


@pytest.mark.parametrize("split", ["train", "val"])
def test_det_seed_draws_match_jax(city_root, split):
    jds = JDataset(split, is_eval=split == "val", native=False,
                   det_seed=7, root=city_root, **KW)
    tds = TDataset(split, det_seed=7, root=city_root, **KW)
    seen = _jax_draws(jds)
    for epoch in (0, 1, 4):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            # the global stream must not matter
            random.seed(epoch * 100 + i)
            want_img, want_lab = jds[i]
            random.seed(12345)
            got_img, got_lab = tds[i]
            label = np.load(os.path.join(tds.annotations_dir,
                                         tds.img_ids[i] + ".npy"))
            assert tds.draw(i, label.shape, WINDOW) == seen[-1]
            np.testing.assert_array_equal(got_lab, want_lab)
            err = np.abs(got_img - want_img)
            assert err.max() <= 2.5e-2 and err.mean() < 8e-3, \
                (epoch, i, err.max(), err.mean())
    # the epoch changes the draws
    assert len(set(seen)) > len(tds)


class _IndexDataset:
    """Item i of epoch e is (i, e): shows which item a batch holds and the
    epoch the loader handed the dataset."""

    def __init__(self, n):
        self.n, self.epoch = n, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i, self.epoch]), np.array([i])


def _draw(loader, n):
    out = []
    while len(out) < n:
        for x, _ in loader:
            out.append(x.tolist())
            if len(out) == n:
                break
    return out


@pytest.mark.parametrize("k", [0, 1, 3, 4, 7])
def test_fast_forward_continues_the_stream(k):
    """7 items at batch 2 (4 batches an epoch, the last ragged): after
    ``fast_forward(k)`` the port's loader yields batch k onwards of a
    fresh loader's stream, which is the JAX loader's, fast-forwarded
    alike."""
    fresh = _draw(TLoader(_IndexDataset(7), 2, shuffle=True, seed=9,
                          num_workers=2), k + 6)
    ff = TLoader(_IndexDataset(7), 2, shuffle=True, seed=9, num_workers=2)
    ff.fast_forward(k)
    assert _draw(ff, 6) == fresh[k:]
    jl = JLoader(_IndexDataset(7), 2, shuffle=True, seed=9, num_workers=2)
    jl.fast_forward(k)
    assert _draw(jl, 6) == fresh[k:]


def test_det_seed_threaded_iterations_repeat(city_root):
    def run():
        ds = TDataset("train", det_seed=3, root=city_root, **KW)
        loader = TLoader(ds, 2, shuffle=True, seed=1, num_workers=4)
        return [b for _ in range(2) for b in loader]

    a, b = run(), run()
    assert len(a) == len(b) == 6
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    # the second epoch draws other crops
    assert not np.array_equal(a[0][0], a[3][0])
