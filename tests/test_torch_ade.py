"""ADE20K in the port against the JAX package.

- ``ADE20K_LABELS`` / ``ADE20k_ID_2_LABEL``, the class count, the class
  names and ``DATA_PATH_ADE`` equal to the JAX package's; ADE's online
  conversion is the identity (its stored ids are final: 0 void, class c
  as c + 1).
- The port's ``baseline_ade``, ``scaleproto_ade`` and
  ``group_scaleproto_ade`` copies hold the JAX files' bindings; each
  builds the JAX package's spec (1800 prototypes over 150 classes: one
  scale under the summed ASPP, four under the concat ASPP, three groups),
  no pyramid; the group config binds no ``train.data_type`` and both
  packages read the data module's.
- The three models, weights carried from the JAX package's by
  ``ppnet_params_to_statedict`` (strict), give its forward on the CPU in
  float32 at ADE's head widths over a tiny backbone.
- ``ade_eval_shape`` equals the JAX package's over drawn sizes and the
  multiples None, 0, 32 and 64; ``prepare_image(..., 'ade')`` is the JAX
  package's ``_prepare_image`` (float64 resize) within float32 rounding
  at an upscale, a downscale and the exact halving.
- ``resize_linear_cv2`` against cv2's float32 ``INTER_LINEAR`` at ADE's
  factors: bit-equal at the downscales and the exact halving; at an 11x
  upscale within one float32 ulp of the image's largest magnitude, and
  only in the clamped border columns.
- Native and numpy items of the port and the JAX package's native items
  bit-equal at ADE's sizes, the 512 window and scales (0.5, 2) (a scaled
  image smaller than the window pads); push items bit-equal to the JAX
  push loader's.
- One micro-step at ADE's head widths for the multiscale and group phases
  against the JAX package's ``make_train_step``, at ``test_torch_coco.py``'s
  tolerances (the single-scale step at Cityscapes' widths:
  ``test_torch_single.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import given, settings as hsettings, strategies as st

from __graft_entry__ import synthetic_init
from scaleprotoseg_tpu import cli_common as jcli
from scaleprotoseg_tpu import configlib as jconfiglib
from scaleprotoseg_tpu import constants as jconstants
from scaleprotoseg_tpu import eval_valid_multiscale as jeval
from scaleprotoseg_tpu import settings as jsettings
from scaleprotoseg_tpu.data.dataset import \
    PatchClassificationDataset as JDataset
from scaleprotoseg_tpu.models import factory as jfactory
from scaleprotoseg_tpu.models.deeplab import DeepLabV2 as JDeepLabV2
from scaleprotoseg_tpu.models.ppnet import PPNet as JPPNet
from scaleprotoseg_tpu.spec import ProtoSpec as JSpec
from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from scaleprotoseg_torch import cli_common, configlib, constants, settings
from scaleprotoseg_torch import eval_valid_multiscale as teval
from scaleprotoseg_torch.cli_common import CONFIGS_DIR
from scaleprotoseg_torch.data.dataset import \
    PatchClassificationDataset as TDataset
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.ops.resize import resize_linear_cv2
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.state import TrainState
from test_torch_coco import HP, _variant
from test_torch_group import _names, _offsets
from torch_parity import port_model, port_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "scaleprotoseg_tpu", "configs")
CONFIGS = ("baseline_ade", "scaleproto_ade", "group_scaleproto_ade")
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
SIDE = 33
CLASSES = 150
# the configs' loss weights
WEIGHTS = {"single": dict(crs_ent=1.0, kld=0.25, l1=1e-5),
           "multiscale": dict(crs_ent=1.0, kld=0.25, l1=1e-5),
           "group": dict(crs_ent=1.0, kld=0.0, l1=1e-4, group_ent=0.25)}
# (prototypes, classes, scales, groups, ASPP) of each variant's config
LAYOUT = {"single": (1800, CLASSES, 1, 0, "sum"),
          "multiscale": (1800, CLASSES, 4, 0, "concat"),
          "group": (1800, CLASSES, 4, 3, "concat")}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(n)


def ade_label(rng, h: int, w: int, blocks=(4, 6), border=None
              ) -> np.ndarray:
    """ADE20K labels as stored (final: 0 void, class c as c + 1): a grid
    of seeded classes 1-150 in blocks, each block framed by ``border``
    void pixels (a quarter of its shorter side by default)."""
    grid = rng.integers(1, CLASSES + 1, blocks).astype(np.uint8)
    bh, bw = -(-h // blocks[0]), -(-w // blocks[1])
    if border is None:
        border = max(1, min(bh, bw) // 4)
    label = np.repeat(np.repeat(grid, bh, 0), bw, 1)[:h, :w].copy()
    rows, cols = np.arange(h) % bh, np.arange(w) % bw
    label[(rows < border) | (rows >= bh - border)] = 0
    label[:, (cols < border) | (cols >= bw - border)] = 0
    return label


def write_ade_root(root: str, splits: dict, seed: int = 0) -> str:
    """ADE20K's preprocessed layout: ``{split: [(h, w), ...]}`` of uint8
    images (a seeded colour per class plus noise) and final labels."""
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
            label = ade_label(rng, h, w)
            noise = rng.integers(-24, 25, (h, w, 3))
            np.save(os.path.join(img_dir, name + ".npy"),
                    np.clip(palette[label] + noise, 0, 255).astype(np.uint8))
            np.save(os.path.join(ann_dir, name + ".npy"), label)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


def test_ade_tables_match_jax():
    assert constants.ADE20K_LABELS == jconstants.ADE20K_LABELS
    assert constants.ADE20k_ID_2_LABEL == jconstants.ADE20k_ID_2_LABEL
    assert len(constants.ADE20K_LABELS) == CLASSES == \
        jconstants.num_classes_for("ade")
    lut = constants.conversion_lut("ade")
    np.testing.assert_array_equal(lut, np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(lut, jconstants.conversion_lut("ade"))
    raw = np.arange(151, dtype=np.uint8).reshape(1, 151)
    got = constants.convert_targets(raw, "ade")
    want = jconstants.convert_targets(raw, "ade",
                                      only_19_from_cityscapes=False)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, raw)
    names = teval.class_names("ade", CLASSES)
    assert names == jeval.class_names("ade", CLASSES)
    assert names[0] == "wall" and names[-1] == "flag"
    assert settings._DATA_ENV["ade"] == jsettings._DATA_ENV["ade"] == \
        "DATA_PATH_ADE"


@pytest.mark.parametrize("name", CONFIGS)
def test_ade_config_matches_jax(name):
    ours = configlib.parse_config_file(os.path.join(CONFIGS_DIR,
                                                    name + ".gin"))
    assert ours == configlib.parse_config_file(
        os.path.join(JAX_CONFIGS, name + ".gin"))
    dataset = ours["PatchClassificationDataset"]
    assert ours["PatchClassificationDataModule"]["data_type"] == "ade"
    assert dataset["data_type"] == "ade"
    assert dataset["window_size"] == (512, 512)
    assert dataset["scales"] == (0.5, 2)
    assert ours["train"]["joint_batch_size"] == 2
    module = ours.get("PatchClassificationModuleMultiScale") or \
        ours["PatchClassificationModule"]
    assert module["iter_size"] == 5
    # the group config binds no train.data_type; both packages read the
    # data module's
    assert ("data_type" in ours["train"]) == (name != "group_scaleproto_ade")
    jconfiglib.clear_config()
    try:
        jconfiglib.parse_config_file(os.path.join(JAX_CONFIGS, name + ".gin"))
        jhp = jcli.train_hparams()
    finally:
        jconfiglib.clear_config()
    hp = cli_common.train_hparams(ours)
    assert hp == jhp and hp["data_type"] == "ade"
    with open(os.path.join(CONFIGS_DIR, name + ".gin")) as f:
        text = f.read()
    assert "GPU training recipe" in text and "TPU" not in text


@pytest.mark.parametrize("name,variant", [
    ("baseline_ade", "single"), ("scaleproto_ade", "multiscale"),
    ("group_scaleproto_ade", "group")])
def test_ade_config_builds_the_jax_spec(name, variant):
    bindings = configlib.parse_config_file(os.path.join(CONFIGS_DIR,
                                                        name + ".gin"))
    assert _variant(bindings) == variant
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
    p, c, s, g, mode = LAYOUT[variant]
    assert (spec.num_prototypes, spec.num_classes, spec.num_scales,
            spec.num_groups) == (p, c, s, g)
    assert spec.num_active_prototypes == p
    assert spec == port_spec(jspec)
    assert model.msc_scales == tuple(jmodel.msc_scales) == ()
    assert model.features.base.aspp.mode == mode
    assert model.prototype_vectors.shape == (p, 64, 1, 1)


# ---------------------------------------------------------------------------
# the three models at ADE's head widths, carried from the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pairs():
    """{variant: (JAX model, spec, variables, port model)}: a backbone of
    one block a stage (ASPP 4 x 64, summed or concatenated) under each
    config's bank of 1800 prototypes over 150 classes, the port's weights
    carried from the JAX package's by ``ppnet_params_to_statedict``."""
    out = {}
    for variant, (p, c, s, g, mode) in LAYOUT.items():
        spec = JSpec.equal_allocation(p, 64, num_classes=c, num_scales=s,
                                      num_groups=g)
        backbone = JDeepLabV2(n_out=64, n_blocks=(1, 1, 1, 1),
                              aspp_mode=mode, dtype=jnp.float32)
        model = JPPNet(backbone=backbone, spec=spec,
                       backbone_channels=spec.feature_depth,
                       add_on_type="deeplab_simple", grouped=bool(g),
                       dtype=jnp.float32,
                       incorrect_strength=0.0 if g else -0.5)
        shapes = jax.eval_shape(
            lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
            jax.random.PRNGKey(0))
        variables = synthetic_init(shapes, seed=1)
        tm = port_model(model, spec, variables)
        tm.incorrect_strength = model.incorrect_strength
        out[variant] = (model, spec, variables, tm)
    return out


def _ade_batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
    y = np.stack([ade_label(rng, SIDE, SIDE, (7, 7), border=1)
                  for _ in range(2)])
    return x, y.astype(np.int32)


@pytest.mark.parametrize("variant", list(LAYOUT))
def test_ade_models_carry_jax_weights(pairs, variant):
    model, spec, variables, tm = pairs[variant]
    x, _ = _ade_batch(3)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    fields = ["logits", "distances", "activations"] + \
        (["group_activations"] if variant == "group" else [])
    assert got.logits.shape == (2, 5, 5, CLASSES)
    assert got.distances.shape[-1] == 1800
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize("variant", ["multiscale", "group"])
def test_ade_micro_step_matches_jax(pairs, variant):
    """``iter_size`` 2, so the accumulated gradient is read before any
    update; the group phase's joint step masks the group last layer and
    projects onto the simplex, as ``test_torch_group`` runs it."""
    model, spec, variables, tm = pairs[variant]
    grouped = variant == "group"
    tm.train()
    tspec = port_spec(spec)
    x, y = _ade_batch()
    assert len(np.unique(y)) > 30 and (y == 0).any()
    w = WEIGHTS[variant]
    extra = dict(grad_mask_last_group=True, project_group_simplex=True) \
        if grouped else {}

    groups = joptim.phase_groups(variant, 1, HP)
    trainable, _ = joptim.partition_params(variables["params"], set(groups))
    tx = joptim.make_phase_optimizer(
        groups, joptim.label_params(trainable),
        schedule=joptim.poly_schedule(0.9, 10), iter_size=2,
        guard_nonfinite=50)
    state = JState.create(variables["params"], variables["batch_stats"],
                          tx.init(trainable))
    fn = jsteps.make_train_step(model, spec, tx, set(groups),
                                jsteps.LossWeights(**w), donate=False,
                                **extra)
    jstate, jm = fn(state, jnp.asarray(x), jnp.asarray(y))

    opt = toptim.PhaseOptimizer(
        tm.named_parameters(), toptim.phase_groups(variant, 1, HP),
        schedule=toptim.poly_schedule(0.9, 10), iter_size=2,
        guard_nonfinite=50)
    step = tsteps.make_train_step(tsteps.LossWeights(**w), **extra)
    got = step(TrainState(tm, opt), torch.from_numpy(x), torch.from_numpy(y))
    tm.eval()
    assert float(got["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-4)
    for k in ("kld", "l1", "group_ent"):
        if k in jm:
            assert float(got[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                                  abs=1e-6), k
    acc = {name: opt._acc[off:off + p.numel()].view_as(p).numpy()
           for name, p, off in _offsets(tm, opt)}
    grads = _names(jstate.opt_state.inner_state.acc_grads, tspec)
    assert set(grads) == set(acc)
    for name, g in grads.items():
        rel = np.linalg.norm(acc[name] - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= 1e-4, (name, rel)
    if grouped:
        assert acc["last_layer_group.weight"].shape == (CLASSES,
                                                        CLASSES * 3)


# ---------------------------------------------------------------------------
# the eval protocol: short side 512, rounded to a multiple
# ---------------------------------------------------------------------------
@hsettings(max_examples=300, deadline=None)
@given(h=st.integers(1, 4096), w=st.integers(1, 4096),
       multiple=st.sampled_from([None, 0, 32, 64]))
def test_ade_eval_shape_matches_jax(h, w, multiple):
    got = teval.ade_eval_shape(h, w, multiple)
    assert got == jeval.ade_eval_shape(h, w, multiple)
    assert all(type(v) is int for v in got)
    if multiple:
        assert got[0] % multiple == 0 and got[1] % multiple == 0


def test_ade_eval_shape_cases():
    assert teval.ade_eval_shape(384, 512) == (512, 683)
    assert teval.ade_eval_shape(384, 512, 64) == (512, 704)
    assert teval.ade_eval_shape(1024, 1536, 64) == (512, 768)
    assert teval.ade_eval_shape(683, 512, 64) == (704, 512)
    assert teval.ade_eval_shape(4, 4000, 64) == (512, 512000)


@pytest.mark.parametrize("size,shape", [
    ((48, 64), (512, 704)), ((768, 1024), (512, 704)),
    ((1024, 1536), (512, 768))], ids=["upscale", "downscale", "halving"])
@pytest.mark.parametrize("multiple", [None, 0])
def test_prepare_image_matches_jax(size, shape, multiple):
    """The port resizes the float32 normalized image with float32
    weights, the JAX package the float64 one with float64 weights.  Each
    output is a convex combination of inputs, so in units of one float32
    ulp u of the image's largest magnitude the two differ by at most: u/2
    from the inputs' rounding, u/2 a pass from its weights' (|t - t32|
    <= 2^-25 times a difference of two inputs), u/2 a pass from its lerp's
    result: 2.5 u, held at 3 u."""
    pytest.importorskip("cv2")
    img = np.random.default_rng(sum(size)).integers(0, 256, (*size, 3),
                                                    dtype=np.uint8)
    m = 64 if multiple is None else None    # the eval's default and exact
    got = teval.prepare_image(img, "ade", m)
    want = jeval._prepare_image(img, size, "ade", m)
    assert got.dtype == np.float32 and want.dtype == np.float64
    th, tw = teval.ade_eval_shape(*size, m)
    assert got.shape == want.shape == (th, tw, 3)
    if m:
        assert (th, tw) == shape
    tol = 3 * np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol


# ---------------------------------------------------------------------------
# the cv2-form resize at ADE's factors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size,out", [
    ((1024, 1536), (512, 768)), ((2048, 1536), (683, 512)),
    ((768, 1024), (512, 683)), ((1000, 1333), (512, 683)),
    ((384, 512), (512, 683))])
def test_resize_linear_cv2_at_ade_factors(size, out):
    """Bit-equal to cv2's float32 ``INTER_LINEAR`` on 3-channel images at
    ADE's downscales (a short side above 512 shrinks), the exact halving
    of both axes (cv2's INTER_AREA path there) and its upscale of a 384 x
    512 image."""
    cv2 = pytest.importorskip("cv2")
    x = (np.random.default_rng(size[0]).standard_normal((*size, 3)) * 2) \
        .astype(np.float32)
    want = cv2.resize(x, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_linear_cv2(torch.from_numpy(x).permute(2, 0, 1), *out)
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)


def test_resize_linear_cv2_large_upscale_bound():
    """At 11x or more (40 x 30 -> 512 x 384, 12.8x) cv2's 3-channel values
    in the clamped border columns (source coordinate outside the image:
    both taps on the edge column) differ from the FMA form by at most one
    float32 ulp of the image's largest magnitude; every other column is
    bit-equal."""
    cv2 = pytest.importorskip("cv2")
    h, w, oh, ow = 40, 30, 512, 384
    x = (np.random.default_rng(1).standard_normal((h, w, 3)) * 2) \
        .astype(np.float32)
    want = cv2.resize(x, (ow, oh), interpolation=cv2.INTER_LINEAR)
    got = resize_linear_cv2(torch.from_numpy(x).permute(2, 0, 1), oh, ow) \
        .permute(1, 2, 0).numpy()
    src = (np.arange(ow) + 0.5) * (w / ow) - 0.5
    border = (src < 0) | (src >= w - 1)
    np.testing.assert_array_equal(got[:, ~border], want[:, ~border])
    diff = np.abs(got[:, border] - want[:, border])
    assert diff.max() <= np.spacing(np.float32(np.abs(x).max()))


# ---------------------------------------------------------------------------
# items at ADE's sizes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def _jax_build_dir(tmp_path_factory):
    """The JAX package builds its native library in place: a directory of
    its own for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPS_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax")))
        yield


@pytest.mark.parametrize("push", [False, True], ids=["train", "push"])
def test_ade_items_match_jax(tmp_path_factory, _jax_build_dir, push):
    """Training items (``det_seed``, two epochs) of the port's native and
    numpy paths and the JAX package's native path, bit for bit, the JAX
    numpy path's labels equal; push items (whole image, normalized)
    bit-equal to the JAX package's push loader's.  At scales 0.5-2 the
    384 x 512 image often falls below the 512 window and pads."""
    root = write_ade_root(
        str(tmp_path_factory.mktemp("ade_items")),
        {"train": [(512, 683), (683, 512), (384, 512)]}, seed=8)
    kw = dict(data_type="ade", mean=MEAN, std=STD, image_margin_size=0,
              window_size=(512, 512), scales=(0.5, 2), root=root,
              det_seed=5)
    if push:
        from scaleprotoseg_tpu.cli_common import PushLoader
        ours = TDataset("train", push_prototypes=True, **kw)
        theirs = PushLoader(JDataset("train", is_eval=True,
                                     push_prototypes=True, **kw))
        for i in range(3):
            (gi, gl), (wi, wl) = ours[i], theirs._item(i)
            assert gi.dtype == wi.dtype and gi.shape == wi.shape
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
        label = np.load(os.path.join(root, "annotations", "train",
                                     "train_002.npy"))
        np.testing.assert_array_equal(ours[2][1], label)
        return
    datasets = {"port native": TDataset("train", native=True, **kw),
                "port numpy": TDataset("train", native=False, **kw),
                "jax native": JDataset("train", is_eval=False,
                                       native=True, **kw)}
    assert datasets["port native"].augmentation == "native"
    jax_numpy = JDataset("train", is_eval=False, native=False, **kw)
    seen = set()
    for epoch in range(2):
        for ds in (*datasets.values(), jax_numpy):
            ds.set_epoch(epoch)
        for i in range(3):
            want = datasets["jax native"][i]
            assert want[0].shape[:2] == (512, 512)
            for name, ds in datasets.items():
                for g, w in zip(ds[i], want):
                    assert g.dtype == w.dtype and g.shape == w.shape, name
                    np.testing.assert_array_equal(g, w, err_msg=name)
            np.testing.assert_array_equal(jax_numpy[i][1], want[1])
            seen |= set(np.unique(want[1]).tolist())
    assert 0 in seen and max(seen) > 100 and seen <= set(range(151))
