"""The port's image writing, resize and push artifacts against the JAX
package and the libraries it renders with, on the CPU.

- ``helpers``: the crop helpers and distances equal to the JAX package's
  on seeded maps;
- ``ops.resize.resize_linear_cv2`` bit-equal to ``cv2.resize(...,
  INTER_LINEAR)`` of float32 maps at the tiny tests' artifact shapes, at
  the card's 129 x 257 -> 1024 x 2048, at odd ratios and downsampling;
- ``imageio``: PNGs decoded by PIL equal to what was written, gray and
  RGB(A); ``imsave_rgb`` equal in decoded pixels to ``plt.imsave``;
  ``save_gray`` to PIL's ``convert("L").save``; ``jet`` to
  ``plt.cm.jet``;
- ``push.artifacts.save_push_artifacts`` on the tiny-depth flagship with
  the JAX package's synthetic weights: fed the JAX package's own
  distances, every file equal to the JAX package's (the ``.npy`` files
  bit for bit, the PNGs in decoded pixels); on its own float32 forward,
  the bound boxes equal, the activations within 1e-6 and the PNGs that do
  not depend on them equal;
- ``push_prototypes(save_artifacts=True)`` of both packages: the same
  file tree and the same bound boxes where the winners are decided.

A comparison library that is missing skips its test.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship, synthetic_init
from scaleprotoseg_tpu import helpers as jhelpers
from scaleprotoseg_tpu.push import push as jpush
from scaleprotoseg_tpu.push.artifacts import save_push_artifacts as jsave
from scaleprotoseg_torch import helpers as thelpers
from scaleprotoseg_torch import imageio
from scaleprotoseg_torch.ops.resize import resize_linear_cv2
from scaleprotoseg_torch.push import push as tpush
from scaleprotoseg_torch.push.artifacts import save_push_artifacts as tsave
from torch_parity import port_model, port_spec

SIDE = 33
NAMES = {c: f"class {c}" for c in range(19)}


class Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def _batches(seed=0, n=3):
    """Seeded 33 x 33 batches of two images, labels in 4 x 5 blocks of
    void and every class."""
    rng = np.random.default_rng(seed)
    y = np.repeat(np.repeat(np.arange(20).reshape(4, 5), 9, 0), 7, 1)
    out = []
    for i in range(n):
        x = rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
        labels = np.stack([np.roll(y[:SIDE, :SIDE], (3 * i + s, 5 * s),
                                   axis=(0, 1)) for s in (0, 1)])
        out.append((x, labels.astype(np.int32)))
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_high_activation_crops_match_jax(seed):
    rng = np.random.default_rng(seed)
    act = rng.random((37, 53)).astype(np.float32)
    act[10:20, 5:30] += 2.0 * seed
    assert thelpers.find_high_activation_crop(act) == \
        jhelpers.find_high_activation_crop(act)
    assert thelpers.find_high_activation_crop(act, 50) == \
        jhelpers.find_high_activation_crop(act, 50)
    for box, thr in (((12, 14, 8, 9), 0.9), ((0, 0, 0, 0), 0.5),
                     ((30, 36, 40, 52), 1.5)):
        assert thelpers.find_continuous_high_activation_crop(
            act, box, thr) == jhelpers.find_continuous_high_activation_crop(
                act, box, thr)
        assert thelpers.find_continuous_high_activation_crop(
            act, box, thr, add_margin=0) == \
            jhelpers.find_continuous_high_activation_crop(act, box, thr,
                                                          add_margin=0)


def test_list_of_distances_and_makedir_match_jax(rng, tmp_path):
    x = rng.standard_normal((7, 5)).astype(np.float32)
    y = rng.standard_normal((4, 5)).astype(np.float32)
    np.testing.assert_array_equal(thelpers.list_of_distances(x, y),
                                  jhelpers.list_of_distances(x, y))
    thelpers.makedir(str(tmp_path / "a" / "b"))
    thelpers.makedir(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()


# ---------------------------------------------------------------------------
# resize, PNG writing, the jet map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(5, 5, 33, 33), (9, 9, 33, 33),
                                   (129, 257, 1024, 2048), (7, 11, 50, 23),
                                   (3, 4, 13, 97), (40, 30, 20, 15),
                                   (33, 33, 33, 33)])
def test_resize_linear_matches_cv2(shape):
    cv2 = pytest.importorskip("cv2")
    h, w, oh, ow = shape
    rng = np.random.default_rng(h * w)
    x = (rng.standard_normal((h, w)) * 3).astype(np.float32)
    want = cv2.resize(x, dsize=(ow, oh), interpolation=cv2.INTER_LINEAR)
    got = resize_linear_cv2(torch.from_numpy(x), oh, ow).numpy()
    np.testing.assert_array_equal(got, want)
    # a leading batch axis resizes each map alike
    batch = resize_linear_cv2(torch.from_numpy(np.stack([x, -x])), oh, ow)
    np.testing.assert_array_equal(batch[1].numpy(), -want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_in_pil(channels, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(channels)
    shape = (17, 29) if channels == 1 else (17, 29, channels)
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    imageio.write_png(path, px)
    img = Image.open(path)
    assert img.mode == {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    np.testing.assert_array_equal(np.asarray(img), px)
    np.testing.assert_array_equal(imageio.read_png(path), px)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_imsave_rgb_matches_matplotlib(dtype, tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    Image = pytest.importorskip("PIL.Image")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(1)
    img = np.clip(rng.random((33, 45, 3)) * 1.2 - 0.1, 0, 1).astype(dtype)
    img[0, :3] = [0.0, 1.0, 254.999 / 255]
    plt.imsave(str(tmp_path / "want.png"), img)
    imageio.imsave_rgb(str(tmp_path / "got.png"), torch.from_numpy(img))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "got.png")),
        np.asarray(Image.open(tmp_path / "want.png")))
    with pytest.raises(ValueError, match="0, 1"):
        imageio.rgba_bytes(torch.from_numpy(img) + 1)


def test_save_gray_matches_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    labels = np.random.default_rng(2).integers(0, 34, (40, 44),
                                                dtype=np.uint8)
    Image.fromarray(labels).convert("L").save(tmp_path / "want.png")
    imageio.save_gray(str(tmp_path / "got.png"), labels)
    want = Image.open(tmp_path / "want.png")
    got = Image.open(tmp_path / "got.png")
    assert got.mode == want.mode == "L"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jet_matches_matplotlib(dtype):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.random(20000), [0, 1, 0.5, 255 / 256, 1 / 256,
                                            np.nan, -0.2, 1.5, np.inf]]
                       ).astype(dtype)
    np.testing.assert_array_equal(imageio.jet(torch.from_numpy(x)).numpy(),
                                  plt.cm.jet(x))


# ---------------------------------------------------------------------------
# push artifacts
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny-depth plain flagship with synthetic weights, its port,
    seeded winners, and the JAX package's artifacts of them."""
    model, spec = _flagship(tiny=True, grouped=False, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=0)
    rng = np.random.default_rng(5)
    P = spec.num_prototypes
    best_img = rng.integers(-1, 6, P)
    best_img[spec.num_active_prototypes:] = -1
    best_flat = rng.integers(0, 25, P)
    loader = Loader(_batches())
    out = tmp_path_factory.mktemp("artifacts")
    want_bb = jsave(model, variables, spec, loader, best_img, best_flat,
                    str(out / "jax"), cls2name=NAMES, log=lambda _: None)

    @jax.jit
    def distances_of(variables, images):
        _, d = model.apply(variables, images, method="push_forward")
        return d

    return dict(model=model, spec=spec, variables=variables,
                tm=port_model(model, spec, variables), best_img=best_img,
                best_flat=best_flat, loader=loader, out=out, want_bb=want_bb,
                jax_distances=lambda x: torch.from_numpy(np.array(
                    distances_of(variables, jnp.asarray(x.numpy())))))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _png(path):
    Image = pytest.importorskip("PIL.Image")
    return np.asarray(Image.open(path))


def test_push_artifacts_match_jax_on_its_distances(tiny):
    """Fed the JAX package's distances, every artifact equals the JAX
    package's: the bound boxes, the activations bit for bit, and every
    PNG in decoded pixels."""
    out = tiny["out"]
    got_bb = tsave(tiny["tm"], port_spec(tiny["spec"]), tiny["loader"],
                   tiny["best_img"], tiny["best_flat"], str(out / "port"),
                   cls2name=NAMES, distances_of=tiny["jax_distances"],
                   log=lambda _: None)
    np.testing.assert_array_equal(got_bb, tiny["want_bb"])
    files = _files(out / "jax")
    assert files == _files(out / "port")
    n_png = 0
    for rel in files:
        a, b = out / "jax" / rel, out / "port" / rel
        if rel.endswith(".png"):
            np.testing.assert_array_equal(_png(b), _png(a), err_msg=rel)
            n_png += 1
        else:
            np.testing.assert_array_equal(np.load(b), np.load(a),
                                          err_msg=rel)
    matched = int((tiny["best_img"] >= 0).sum())
    assert n_png == 4 * matched


def test_push_artifacts_on_the_port_forward(tiny):
    """On the port's own float32 forward: the same bound boxes, the
    activations within 1e-6, and the original, crop and class-mask PNGs
    equal (the heat-map overlay follows the activations' last bits)."""
    out = tiny["out"]
    got_bb = tsave(tiny["tm"], port_spec(tiny["spec"]), tiny["loader"],
                   tiny["best_img"], tiny["best_flat"], str(out / "own"),
                   cls2name=NAMES, log=lambda _: None)
    np.testing.assert_array_equal(got_bb, tiny["want_bb"])
    np.testing.assert_array_equal(
        np.load(out / "own" / "bb-receptive_field.npy"), tiny["want_bb"])
    files = _files(out / "jax")
    assert files == _files(out / "own")
    for rel in files:
        a, b = out / "jax" / rel, out / "own" / rel
        if rel.endswith(".npy") and "self-act" in rel:
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=0,
                                       atol=1e-6, err_msg=rel)
        elif rel.endswith(".png") and "self_act" not in rel:
            np.testing.assert_array_equal(_png(b), _png(a), err_msg=rel)


def test_push_prototypes_writes_the_artifacts_of_jax(tiny):
    """``push_prototypes(save_artifacts=True)`` of both packages over the
    same loader: the same files, and the same bound boxes for every
    prototype whose winner both pushes found."""
    out = tiny["out"]
    loader = tiny["loader"]
    want = jpush.push_prototypes(
        tiny["model"], tiny["variables"], tiny["spec"], loader,
        prototypes_dir=str(out / "push_jax"), save_artifacts=True,
        cls2name=NAMES, log=lambda _: None)
    tm = port_model(tiny["model"], tiny["spec"], tiny["variables"])
    got = tpush.push_prototypes(tm, port_spec(tiny["spec"]), loader,
                                prototypes_dir=str(out / "push_port"),
                                save_artifacts=True, cls2name=NAMES,
                                log=lambda _: None)
    assert _files(out / "push_jax") == _files(out / "push_port")
    same = got.winners == want.winners
    assert same.mean() > 0.8
    bb_j = np.load(out / "push_jax" / "bb.npy")
    bb_t = np.load(out / "push_port" / "bb.npy")
    assert bb_t.shape == (tiny["spec"].num_prototypes, 6)
    np.testing.assert_array_equal(bb_t[same], bb_j[same])
    # without a directory nothing is written and nothing is refused
    tpush.push_prototypes(port_model(tiny["model"], tiny["spec"],
                                     tiny["variables"]),
                          port_spec(tiny["spec"]), loader,
                          save_artifacts=True, log=lambda _: None)
