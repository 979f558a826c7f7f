"""COCO-Stuff in the port against the JAX package.

- ``COCO_ID_MAPPING`` / ``COCO_LUT`` / the class names equal to the JAX
  package's; COCO's online conversion is the identity (its stored ids are
  final), EM stays refused by name.
- The port's ``scaleproto_coco``, ``baseline_coco`` and
  ``group_scaleproto_coco`` copies hold the JAX files' bindings; each
  builds the JAX package's spec, the reference's naming swap kept:
  ``scaleproto_coco`` is the single-scale model (summed ASPP, 2184 / 182 /
  1), ``baseline_coco`` the multiscale one (concat ASPP, 2184 / 182 / 4),
  ``group_scaleproto_coco`` 2054 / 182 / 4 with 2052 active, all with the
  pyramid (0.5, 0.75).
- ``train.load_coco`` is read as the JAX package reads it, and nothing in
  the port uses it (as nothing in the JAX package does).
- One joint micro-step at COCO's head widths (the tiny MSC backbone, the
  configs' banks over 182 classes, the configs' loss weights: KLD and L1
  over 12 prototypes a class; the group phase with its projection and
  group entropy) against the JAX package's ``make_train_step``: loss
  within 1e-4, every accumulated gradient within 1e-4 relative L2.
- Native and numpy items of the port and the JAX package's native items
  bit-equal at COCO's sizes (480 x 640, 640 x 480, 427 x 640), the 321
  window and scales (0.5, 1.5), labels 0-182 passing through.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import synthetic_init
from scaleprotoseg_tpu import cli_common as jcli
from scaleprotoseg_tpu import configlib as jconfiglib
from scaleprotoseg_tpu import constants as jconstants
from scaleprotoseg_tpu import eval_valid_multiscale as jeval
from scaleprotoseg_tpu.data.dataset import \
    PatchClassificationDataset as JDataset
from scaleprotoseg_tpu.models import factory as jfactory
from scaleprotoseg_tpu.models.deeplab import DeepLabV2 as JDeepLabV2
from scaleprotoseg_tpu.models.ppnet import PPNet as JPPNet
from scaleprotoseg_tpu.spec import ProtoSpec as JSpec
from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from scaleprotoseg_torch import cli_common, configlib, constants
from scaleprotoseg_torch import eval_valid_multiscale as teval
from scaleprotoseg_torch.cli_common import CONFIGS_DIR
from scaleprotoseg_torch.data.dataset import \
    PatchClassificationDataset as TDataset
from scaleprotoseg_torch.models.factory import construct_ppnet
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.state import TrainState
from test_torch_group import _names, _offsets
from torch_parity import port_model, port_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "scaleprotoseg_tpu", "configs")
CONFIGS = ("scaleproto_coco", "baseline_coco", "group_scaleproto_coco")
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
SIDE = 33
# the configs' learning rates (baseline_coco's; the group config's group
# and last-layer rates)
HP = dict(warm_lr_add_on=2.5e-4, warm_lr_protos=2.5e-4, warm_wd=5e-4,
          joint_lr_features=2.5e-5, joint_lr_add_on=2.5e-4,
          joint_lr_protos=2.5e-4, joint_wd=5e-4, last_layer_lr=2.5e-4,
          warm_lr_group=2.5e-4, joint_lr_group=2.5e-4)
# the configs' loss weights
WEIGHTS = {"multiscale": dict(crs_ent=1.0, kld=0.25, l1=1e-5),
           "group": dict(crs_ent=1.0, kld=0.0, l1=1e-4, group_ent=0.25)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(n)


def coco_label(rng, h: int, w: int, blocks=(6, 8)) -> np.ndarray:
    """COCO-Stuff labels as stored (final: 0 void, class c as c + 1): a
    grid of seeded classes 1-182 with void (0) cells among them."""
    grid = rng.integers(0, 183, blocks).astype(np.uint8)
    label = np.repeat(np.repeat(grid, -(-h // blocks[0]), 0),
                      -(-w // blocks[1]), 1)[:h, :w]
    return np.ascontiguousarray(label)


def write_coco_root(root: str, splits: dict, seed: int = 0) -> str:
    """COCO-Stuff's preprocessed layout: ``{split: [(h, w), ...]}`` of
    uint8 images (a seeded colour per class plus noise) and final labels."""
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
            label = coco_label(rng, h, w)
            noise = rng.integers(-24, 25, (h, w, 3))
            np.save(os.path.join(img_dir, name + ".npy"),
                    np.clip(palette[label] + noise, 0, 255).astype(np.uint8))
            np.save(os.path.join(ann_dir, name + ".npy"), label)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(index, f)
    return root


def test_coco_tables_match_jax():
    assert constants.COCO_ID_MAPPING == jconstants.COCO_ID_MAPPING
    np.testing.assert_array_equal(constants.COCO_LUT, jconstants.COCO_LUT)
    assert constants.COCO_LABELS == jconstants.COCO_LABELS
    lut = constants.conversion_lut("coco")
    np.testing.assert_array_equal(lut, np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(lut, jconstants.conversion_lut("coco"))
    raw = np.arange(183, dtype=np.uint8).reshape(3, 61)
    got = constants.convert_targets(raw, "coco")
    want = jconstants.convert_targets(raw, "coco",
                                      only_19_from_cityscapes=False)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, raw)
    names = teval.class_names("coco", 182)
    assert names == jeval.class_names("coco", 182)
    assert "traffic light" in names
    # ADE's and EM's stored ids are final too (tests/test_torch_ade.py,
    # tests/test_torch_em.py); a data type the port does not know is
    # refused by name
    assert constants.conversion_lut("ade") is constants.IDENTITY_LUT
    assert constants.conversion_lut("em") is constants.IDENTITY_LUT
    with pytest.raises(NotImplementedError, match="camvid"):
        constants.conversion_lut("camvid")


@pytest.mark.parametrize("name", CONFIGS)
def test_coco_config_matches_jax(name):
    ours = configlib.parse_config_file(os.path.join(CONFIGS_DIR,
                                                    name + ".gin"))
    assert ours == configlib.parse_config_file(
        os.path.join(JAX_CONFIGS, name + ".gin"))
    dataset = ours["PatchClassificationDataset"]
    assert ours["PatchClassificationDataModule"]["train_key"] == "train"
    assert dataset["data_type"] == "coco"
    assert dataset["image_margin_size"] == 0
    assert dataset["window_size"] == (321, 321)
    assert dataset["scales"] == (0.5, 1.5)
    assert ours["train"]["joint_batch_size"] == 10
    module = ours.get("PatchClassificationModuleMultiScale") or \
        ours["PatchClassificationModule"]
    assert module["iter_size"] == 1
    with open(os.path.join(CONFIGS_DIR, name + ".gin")) as f:
        text = f.read()
    assert "GPU training recipe" in text and "TPU" not in text


def _variant(bindings) -> str:
    """As the JAX package's config tests sniff it: the name does not say
    (``baseline_coco`` is the multiscale model)."""
    if "construct_PPNet_Group" in bindings:
        return "group"
    if "num_scales" in bindings.get("PPNetMultiScale", {}):
        return "multiscale"
    return "single"


@pytest.mark.parametrize("name,variant,layout", [
    ("scaleproto_coco", "single", (2184, 2184, 182, 1, 0)),
    ("baseline_coco", "multiscale", (2184, 2184, 182, 4, 0)),
    ("group_scaleproto_coco", "group", (2054, 2052, 182, 4, 3))])
def test_coco_config_builds_the_jax_spec(name, variant, layout):
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
        jhp = jcli.train_hparams()
    finally:
        jconfiglib.clear_config()
    assert model.msc_scales == tuple(jmodel.msc_scales) == (0.5, 0.75)
    assert (spec.num_prototypes, spec.num_active_prototypes,
            spec.num_classes, spec.num_scales, spec.num_groups) == layout
    assert spec == port_spec(jspec)
    assert model.features.base.aspp.mode == \
        ("sum" if variant == "single" else "concat")
    assert model.prototype_vectors.shape == (layout[0], 64, 1, 1)
    # train.load_coco: read as the JAX package reads it
    hp = cli_common.train_hparams(bindings)
    assert hp == jhp
    assert hp.get("load_coco", False) is False


def test_load_coco_is_read_and_used_nowhere():
    """The JAX package reads ``train.load_coco`` and never uses it; the
    port reads it (``cli_common.train_hparams``) and its one mention in
    the package is that read."""
    bindings = configlib.parse_config_file(
        os.path.join(CONFIGS_DIR, "baseline_coco.gin"))
    bindings["train"]["load_coco"] = True
    assert cli_common.train_hparams(bindings)["load_coco"] is True
    pkg = os.path.join(REPO, "scaleprotoseg_torch")
    hits = []
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    hits += [f for line in fh if "load_coco" in line]
    assert hits == ["cli_common.py"]


# ---------------------------------------------------------------------------
# one joint micro-step at COCO's head widths
# ---------------------------------------------------------------------------
def _coco_pair(variant: str):
    """(JAX model, spec, variables, port model): the tiny concat-ASPP
    MSC backbone (ResNet stages of one block, 4 x 64 channels) under the
    config's bank over 182 classes."""
    grouped = variant == "group"
    spec = JSpec.equal_allocation(2054 if grouped else 2184, 64,
                                  num_classes=182, num_scales=4,
                                  num_groups=3 if grouped else 0)
    backbone = JDeepLabV2(n_out=64, n_blocks=(1, 1, 1, 1),
                          aspp_mode="concat", dtype=jnp.float32)
    model = JPPNet(backbone=backbone, spec=spec,
                   backbone_channels=spec.feature_depth,
                   add_on_type="deeplab_simple", grouped=grouped,
                   dtype=jnp.float32, msc_scales=(0.5, 0.75),
                   incorrect_strength=0.0 if grouped else -0.5)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=0)
    tm = port_model(model, spec, variables)
    tm.msc_scales = (0.5, 0.75)
    tm.incorrect_strength = model.incorrect_strength
    return model, spec, variables, tm


def _coco_batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
    y = np.stack([coco_label(rng, SIDE, SIDE, (5, 5)) for _ in range(2)])
    return x, y.astype(np.int32)


@pytest.mark.parametrize("variant", ["multiscale", "group"])
def test_coco_micro_step_matches_jax(variant):
    """``iter_size`` 2, so the accumulated gradient is read before any
    update; the group phase's joint step masks the group last layer and
    projects onto the simplex, as ``test_torch_group`` runs it."""
    model, spec, variables, tm = _coco_pair(variant)
    grouped = variant == "group"
    tm.train()
    tspec = port_spec(spec)
    x, y = _coco_batch()
    assert len(np.unique(y)) > 30
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
        assert acc["last_layer_group.weight"].shape == (182, 182 * 3)


# ---------------------------------------------------------------------------
# items at COCO's sizes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def _jax_build_dir(tmp_path_factory):
    """The JAX package builds its native library in place: a directory of
    its own for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPS_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax")))
        yield


@pytest.mark.parametrize("push", [False, True], ids=["train", "push"])
def test_coco_items_match_jax(tmp_path_factory, _jax_build_dir, push):
    """Training items (``det_seed``, two epochs) of the port's native and
    numpy paths and the JAX package's native path, bit for bit, the JAX
    numpy path's labels equal; push items (whole image, normalized)
    bit-equal to the JAX package's push loader's.  Labels pass through:
    every stored id 0-182 may appear."""
    root = write_coco_root(
        str(tmp_path_factory.mktemp("coco_items")),
        {"train": [(480, 640), (640, 480), (427, 640)]}, seed=8)
    kw = dict(data_type="coco", mean=MEAN, std=STD, image_margin_size=0,
              window_size=(321, 321), scales=(0.5, 1.5), root=root,
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
                                     "train_000.npy"))
        np.testing.assert_array_equal(ours[0][1], label)
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
            for name, ds in datasets.items():
                for g, w in zip(ds[i], want):
                    assert g.dtype == w.dtype and g.shape == w.shape, name
                    np.testing.assert_array_equal(g, w, err_msg=name)
            np.testing.assert_array_equal(jax_numpy[i][1], want[1])
            seen |= set(np.unique(want[1]).tolist())
    assert max(seen) > 150 and seen <= set(range(183))
