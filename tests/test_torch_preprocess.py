"""The port's offline preprocessing against the JAX package's, on raw
trees that PIL writes here.

For Cityscapes, Pascal (with a ``test`` split and a palette label), ADE20K,
COCO-Stuff, EM, both panoptic-parts decoders and ``img_to_numpy``, the
JAX package's function and the port's run on one synthetic raw tree into
two targets; then

- ``all_images.json`` is equal, order included;
- every ``.npy`` is byte-equal (dtype and shape included);
- every written PNG decodes to the same pixels;
- EM's seeded split is equal, and the port leaves the global numpy state
  as it was;
- the CLIs' argparse surfaces are the same;
- ``settings.source_data_path`` reads ``SOURCE_DATA_PATH_*`` and gives
  the empty string when unset, as the JAX package's;
- the preprocessing modules import without torch;
- ``serve._load`` decodes a ``.png`` and a ``.jpg`` as the JAX serve CLI
  does, and ``run_serving`` writes label PNGs equal to PIL's
  ``Image.fromarray(pred).convert("L")``.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import scaleprotoseg_tpu.data.preprocess as jpre
import scaleprotoseg_torch.data.preprocess as tpre
from scaleprotoseg_tpu import settings as jsettings
from scaleprotoseg_torch import settings as tsettings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ["preprocess_cityscapes", "preprocess_pascal", "preprocess_ade",
        "preprocess_coco", "preprocess_em", "img_to_numpy",
        "preprocess_part_cityscapes", "preprocess_part_pascal"]


def _photo(rng, h, w):
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 3 + y, x + y * 2, x * y // 5], -1)
    return np.clip(base % 256 + rng.integers(-30, 30, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _labels(rng, h, w, values):
    return rng.choice(np.asarray(values), size=(h, w)).astype(np.uint8)


def _assert_trees_equal(a, b):
    """Same files; ``.npy`` byte-equal, PNGs decode-equal, JSON equal."""
    files = []
    for root, _, names in os.walk(a):
        files += [os.path.relpath(os.path.join(root, n), a) for n in names]
    other = []
    for root, _, names in os.walk(b):
        other += [os.path.relpath(os.path.join(root, n), b) for n in names]
    assert sorted(files) == sorted(other)
    assert files
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and x.shape == y.shape, rel
            assert x.tobytes() == y.tobytes(), rel
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)),
                                          np.asarray(Image.open(pb)),
                                          err_msg=rel)
        elif rel.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), rel
        else:
            raise AssertionError(f"unexpected file {rel}")
    return files


def _both(tmp_path, name, source, **kw):
    """Run ``name`` of both packages on ``source``; the targets."""
    out = {}
    for tag, mod in (("jax", jpre), ("port", tpre)):
        target = tmp_path / f"{name}_{tag}"
        getattr(mod, name)(source=str(source), target=str(target), **kw)
        out[tag] = str(target)
    return out["jax"], out["port"]


def test_cityscapes(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "raw"
    official = [0, 1, 4, 7, 8, 11, 17, 21, 23, 24, 26, 33]
    for split, cities in (("train", ("aachen", "bremen")), ("val",
                                                           ("lindau",)),
                          ("test", ("berlin",))):
        for city in cities:
            gt = src / "gtFine" / split / city
            im = src / "leftImg8bit" / split / city
            gt.mkdir(parents=True)
            im.mkdir(parents=True)
            for k in (3, 1, 2):
                stem = f"{city}_{k:06d}_000019"
                Image.fromarray(_labels(rng, 24, 40, official)).save(
                    gt / f"{stem}_gtFine_labelIds.png")
                Image.fromarray(_photo(rng, 24, 40)).save(
                    im / f"{stem}_leftImg8bit.png")
            # the other gtFine files are skipped
            Image.fromarray(_photo(rng, 24, 40)).save(
                gt / f"{city}_000001_000019_gtFine_color.png")
    a, b = _both(tmp_path, "preprocess_cityscapes", src, n_jobs=2)
    files = _assert_trees_equal(a, b)
    with open(os.path.join(b, "all_images.json")) as f:
        index = json.load(f)
    assert index["train"][:3] == [f"aachen_{k:06d}_000019" for k in (1, 2,
                                                                      3)]
    assert len(files) == 12 * 3 + 1


def test_pascal_with_test_split_and_palette_label(tmp_path):
    rng = np.random.default_rng(1)
    src = tmp_path / "raw"
    for sub in ("JPEGImages", "SegmentationClassAug",
                "ImageSets/SegmentationAug"):
        (src / sub).mkdir(parents=True)
    ids = {"train_aug": ["2007_000032", "2008_000002", "2011_000003"],
           "train": ["2007_000032"], "val": ["2007_000033"],
           "test": ["2008_000010", "2008_000011"]}
    pal = rng.integers(0, 256, 768).astype(np.uint8)
    for split, names in ids.items():
        with open(src / "ImageSets/SegmentationAug" / f"{split}.txt",
                  "w") as f:
            for n in names:
                f.write(f"/JPEGImages/{n}.jpg /SegmentationClassAug/{n}.png\n")
        for n in names:
            h, w = 37, 50
            Image.fromarray(_photo(rng, h, w)).save(
                src / "JPEGImages" / f"{n}.jpg", quality=85)
            if split == "test":
                continue
            lab = _labels(rng, h, w, [0, 1, 5, 15, 20, 255])
            if n == "2008_000002":  # a palette label (VOC's own format)
                img = Image.fromarray(lab, "P")
                img.putpalette(pal.tobytes())
            else:
                img = Image.fromarray(lab)
            img.save(src / "SegmentationClassAug" / f"{n}.png")
    a, b = _both(tmp_path, "preprocess_pascal", src, n_jobs=2)
    _assert_trees_equal(a, b)
    with open(os.path.join(b, "all_images.json")) as f:
        assert json.load(f) == ids
    assert os.listdir(os.path.join(b, "annotations", "test")) == []
    # the palette label is stored as the palette's red value, not the
    # class index: the JAX package's convert("RGB")[:, :, 0], kept
    lab = np.asarray(Image.open(src / "SegmentationClassAug" /
                                "2008_000002.png"))
    stored = np.load(os.path.join(b, "annotations", "train_aug",
                                  "2008_000002.npy"))
    np.testing.assert_array_equal(stored, pal.reshape(-1, 3)[lab, 0])


@pytest.mark.parametrize("dataset", ["ade", "coco"])
def test_ade_and_coco(tmp_path, dataset):
    rng = np.random.default_rng(2)
    src = tmp_path / "raw"
    splits = (("training", "validation") if dataset == "ade"
              else ("train2017", "val2017"))
    for split_in in splits:
        (src / "images" / split_in).mkdir(parents=True)
        (src / "annotations" / split_in).mkdir(parents=True)
        for k, (h, w) in enumerate([(31, 45), (40, 29), (33, 33)]):
            n = f"{split_in}_{5 - k:08d}"
            Image.fromarray(_photo(rng, h, w)).save(
                src / "images" / split_in / f"{n}.jpg", quality=90,
                subsampling=k % 3)
            lab = _labels(rng, h, w, [0, 3, 90, 150, 181, 255])
            Image.fromarray(lab).save(src / "annotations" / split_in /
                                      f"{n}.png")
    a, b = _both(tmp_path, f"preprocess_{dataset}", src, n_jobs=2)
    _assert_trees_equal(a, b)
    with open(os.path.join(b, "all_images.json")) as f:
        index = json.load(f)
    assert sorted(index) == ["train", "val"]
    assert index["train"] == sorted(index["train"])


def test_em_split_and_global_state(tmp_path):
    rng = np.random.default_rng(3)
    src = tmp_path / "raw"
    src.mkdir()
    frames = [Image.fromarray(_photo(rng, 32, 32)[..., 0])
              for _ in range(30)]
    labels = [Image.fromarray(_labels(rng, 32, 32, [0, 255]))
              for _ in range(30)]
    frames[0].save(src / "train-volume.tif", save_all=True,
                   append_images=frames[1:])
    labels[0].save(src / "train-labels.tif", save_all=True,
                   append_images=labels[1:], compression="tiff_lzw")
    np.random.seed(1234)
    state = np.random.get_state()
    tpre.preprocess_em(source=str(src), target=str(tmp_path / "em_port"))
    after = np.random.get_state()
    assert all(np.array_equal(x, y) for x, y in zip(state, after))
    jpre.preprocess_em(source=str(src), target=str(tmp_path / "em_jax"))
    _assert_trees_equal(str(tmp_path / "em_jax"), str(tmp_path / "em_port"))
    with open(tmp_path / "em_port" / "all_images.json") as f:
        index = json.load(f)
    np.random.seed(42)
    assert index["val"] == [str(i) for i in np.random.choice(30, 10,
                                                             replace=False)]
    assert tpre.em_val_ids(30, 42) == [int(i) for i in index["val"]]


def test_part_decoders(tmp_path):
    from scaleprotoseg_tpu.data.preprocess_part_cityscapes import \
        preprocess_part_cityscapes as jcity
    from scaleprotoseg_tpu.data.preprocess_part_pascal import \
        preprocess_part_pascal as jpascal
    from scaleprotoseg_torch.data.panoptic_parts_lite import decode_uids
    from scaleprotoseg_torch.data.preprocess_part_cityscapes import \
        preprocess_part_cityscapes as tcity
    from scaleprotoseg_torch.data.preprocess_part_pascal import \
        preprocess_part_pascal as tpascal
    from scaleprotoseg_tpu.data.panoptic_parts_lite import \
        decode_uids as jdecode

    rng = np.random.default_rng(4)
    uids = np.array([0, 7, 24, 26_001, 24_012, 2_400_105, 2_612_399,
                     9_999_999, 99], np.int32)
    src = tmp_path / "raw"
    for split in ("val", "train"):
        for city in ("lindau", "munster"):
            d = src / "gtFinePanopticParts" / split / city
            d.mkdir(parents=True)
            for k in range(2):
                a = rng.choice(uids, size=(20, 30)).astype(np.int32)
                comp = "tiff_lzw" if k else None
                Image.fromarray(a).save(
                    d / f"{city}_{k:06d}_000019_gtFinePanopticParts.tif",
                    **({"compression": comp} if comp else {}))
        d = src / "pascal_panoptic_parts" / "labels" / split
        d.mkdir(parents=True)
        Image.fromarray(rng.choice(uids, size=(20, 30)).astype(np.int32)
                        ).save(d / "2008_000002.tif")
        Image.fromarray(rng.choice(uids[uids < 65536], size=(20, 30))
                        .astype(np.uint16)).save(d / "2008_000003.png")
    for jfn, tfn in ((jcity, tcity), (jpascal, tpascal)):
        for splits in (("val",), ("val", "train", "test")):
            tag = f"{tfn.__name__}_{len(splits)}"
            jfn(source=str(src), target=str(tmp_path / f"{tag}_jax"),
                splits=splits)
            tfn(source=str(src), target=str(tmp_path / f"{tag}_port"),
                splits=splits)
            files = _assert_trees_equal(str(tmp_path / f"{tag}_jax"),
                                        str(tmp_path / f"{tag}_port"))
            assert len(files) == 3 * (4 if "city" in tag else 2) * \
                len(set(splits) - {"test"})
    for got, want in zip(decode_uids(uids), jdecode(uids)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_img_to_numpy(tmp_path, monkeypatch):
    for tag in ("jax", "port"):
        for split in ("train", "val"):
            d = tmp_path / tag / "img_with_margin_0" / split
            d.mkdir(parents=True)
            r = np.random.default_rng(5)
            for k in range(2):
                # PIL's PNGs: adaptive filters, and a palette file
                a = _photo(r, 21, 34)
                im = [Image.fromarray(a), Image.fromarray(a).quantize(9)][k]
                im.save(d / f"img_{k}.png")
    monkeypatch.setenv("DATA_PATH_CITY", str(tmp_path / "jax"))
    jpre.img_to_numpy("cityscapes")
    monkeypatch.setenv("DATA_PATH_CITY", str(tmp_path / "port"))
    tpre.img_to_numpy("cityscapes")
    files = _assert_trees_equal(str(tmp_path / "jax"),
                                str(tmp_path / "port"))
    assert len(files) == 8
    # the margin pad: 'symmetric', as the JAX package's PIL path
    a = _photo(np.random.default_rng(6), 9, 11)
    np.testing.assert_array_equal(
        tpre.add_margins_to_image(a, 3),
        np.asarray(jpre.add_margins_to_image(Image.fromarray(a), 3)))


def _parser(module) -> argparse.ArgumentParser:
    """The parser a CLI's ``main`` builds, caught at ``parse_args``."""
    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        module.main()
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError(f"{module.__name__}.main parsed nothing")


def test_cli_surfaces_match():
    for name in CLIS:
        surfaces = []
        for pkg in ("scaleprotoseg_tpu", "scaleprotoseg_torch"):
            p = _parser(importlib.import_module(f"{pkg}.data.{name}"))
            surfaces.append([(a.option_strings, a.dest, a.nargs, a.default,
                              a.type, a.required) for a in p._actions])
        assert surfaces[0] == surfaces[1], name


def test_source_data_path(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for key in ("CITY", "PASCAL", "ADE", "COCO", "EM"):
        monkeypatch.delenv(f"SOURCE_DATA_PATH_{key}", raising=False)
    for kind in ("cityscapes", "pascal", "ade", "coco", "em"):
        assert tsettings.source_data_path(kind) == \
            jsettings.source_data_path(kind) == ""
    monkeypatch.setenv("SOURCE_DATA_PATH_COCO", "/raw/coco")
    assert tsettings.source_data_path("coco") == "/raw/coco"
    monkeypatch.delenv("SOURCE_DATA_PATH_COCO")
    (tmp_path / ".env").write_text("SOURCE_DATA_PATH_ADE='/raw/ade'\n")
    assert tsettings.source_data_path("ade") == "/raw/ade"


_NO_TORCH = r"""
import sys
sys.modules["torch"] = None
sys.modules["PIL"] = None
import importlib
for name in %r:
    importlib.import_module("scaleprotoseg_torch.data." + name)
import scaleprotoseg_torch.codecs
print("ok")
"""


def test_preprocessing_imports_without_torch():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _NO_TORCH % (CLIS,)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_serve_decodes_and_writes_without_pil(tmp_path, monkeypatch):
    """The port's ``serve._load`` of a ``.png`` and a ``.jpg`` equals the
    JAX serve CLI's decode; ``run_serving``'s label PNGs equal PIL's
    ``Image.fromarray(pred).convert("L")`` and are written with PIL
    blocked."""
    import torch

    from scaleprotoseg_tpu.serving.serve import \
        _make_preprocess as jpreprocess
    from scaleprotoseg_torch.serving import serve

    rng = np.random.default_rng(7)
    inputs = tmp_path / "in"
    inputs.mkdir()
    Image.fromarray(_photo(rng, 27, 35)).save(inputs / "a.png")
    Image.fromarray(_photo(rng, 27, 35)).save(inputs / "b.jpg", quality=80)
    Image.fromarray(_photo(rng, 27, 35)[..., 0]).save(inputs / "c.jpg")
    jload = jpreprocess(str(inputs), normalize=False)
    for name in ("a.png", "b.jpg", "c.jpg"):
        got = serve._load(str(inputs / name))
        want = jload(name)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)

    preds = {n: rng.integers(0, 20, (27, 35)).astype(np.int64)
             for n in ("a.png", "b.jpg", "c.jpg")}
    names = sorted(preds)
    stack = np.stack([preds[n] for n in names])

    def predict(x):
        return torch.as_tensor(stack[x[:, 0, 0, 0].long().numpy()])

    index = {n: i for i, n in enumerate(names)}
    out = tmp_path / "out"
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        m.setitem(sys.modules, "PIL.Image", None)
        record = serve.run_serving(
            predict, names,
            lambda n: np.full((2, 2, 3), index[n], np.float32), str(out),
            batch_size=2, device=torch.device("cpu"))
    assert record["images"] == 3
    for n in names:
        path = out / (os.path.splitext(n)[0] + ".png")
        want = np.asarray(Image.fromarray(preds[n].astype(np.uint8))
                          .convert("L"))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
