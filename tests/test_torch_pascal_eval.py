"""Pascal VOC-2012's evaluation and test export in the port against the
JAX package, on a synthetic Pascal root with mixed image and annotation
sizes and a tiny MSC model (ResNet stages of one block, concat ASPP of 4 x
64, the group head of 252 prototypes over 21 classes, pyramid (0.5,
0.75)), weights carried over by ``ppnet_params_to_statedict``:

- ``eval_valid_multiscale`` with Pascal's protocol (normalized, 513 x 513
  input, labels upsampled to each annotation's size) gives the JAX
  package's mIoU and pixel accuracy within 1e-6, batching images only
  while the image and annotation shapes repeat;
- ``eval_test --pascal`` writes the JAX package's ``--fp32`` PNGs (Pascal
  label ids), value for value.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import synthetic_init
from scaleprotoseg_tpu import eval_test as jeval_test
from scaleprotoseg_tpu import eval_valid_multiscale as jeval
from scaleprotoseg_tpu.models.deeplab import DeepLabV2 as JDeepLabV2
from scaleprotoseg_tpu.models.ppnet import PPNet as JPPNet
from scaleprotoseg_tpu.spec import ProtoSpec as JSpec
from scaleprotoseg_torch import eval_test as teval_test
from scaleprotoseg_torch import eval_valid_multiscale as teval
from scaleprotoseg_torch.imageio import read_png
from test_torch_pascal import write_pascal_root
from torch_parity import port_model, port_spec

# val annotation sizes: one repeats, then another (batch 2, then 1)
VAL_SIZES = [(60, 80), (60, 80), (80, 60)]
TEST_SIZES = [(60, 80), (80, 60), (60, 80)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_msc():
    """(JAX model, spec, variables, the port's model, its spec): the
    grouped head of ``group_scaleproto_pascal`` (252 / 21 / 4 / 3) over a
    one-block-a-stage backbone, with the pyramid."""
    spec = JSpec.equal_allocation(252, 64, num_classes=21, num_scales=4,
                                  num_groups=3)
    model = JPPNet(backbone=JDeepLabV2(n_out=64, n_blocks=(1, 1, 1, 1),
                                       aspp_mode="concat", dtype=jnp.float32),
                   spec=spec, backbone_channels=spec.feature_depth,
                   add_on_type="deeplab_simple", grouped=True,
                   msc_scales=(0.5, 0.75), dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 65, 65, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=4)
    tm = port_model(model, spec, variables)
    tm.msc_scales = (0.5, 0.75)
    return model, spec, variables, tm, port_spec(spec)


@pytest.fixture(scope="module")
def pascal_root(tmp_path_factory):
    return write_pascal_root(str(tmp_path_factory.mktemp("pascal")),
                             {"val": VAL_SIZES, "test": TEST_SIZES}, seed=3)


def test_pascal_eval_matches_jax(tiny_msc, pascal_root, tmp_path,
                                 monkeypatch):
    model, spec, variables, tm, tspec = tiny_msc
    monkeypatch.setattr(jeval, "load_model",
                        lambda *a, **k: (model, spec, variables))
    monkeypatch.setattr(teval, "load_model", lambda *a, **k: (tm, tspec))
    batches = []
    real_update = teval.SegEvaluator.update

    def update(self, images, targets):
        batches.append((tuple(images.shape), tuple(targets.shape)))
        return real_update(self, images, targets)

    monkeypatch.setattr(teval.SegEvaluator, "update", update)
    got = teval.main(["run", "final-group", "2", "pascal", "--device", "cpu",
                      "--data-root", pascal_root, "--results-root",
                      str(tmp_path / "port")])
    want = jeval.run_evaluation(
        "run", "final-group", batch_size=2, data_type="pascal",
        data_root=pascal_root, results_root=str(tmp_path / "jax"),
        fp32=True)
    # 513 x 513 inputs, batched only while image and annotation repeat
    assert batches == [((2, 513, 513, 3), (2, 60, 80)),
                       ((1, 513, 513, 3), (1, 80, 60))]
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-6
    assert abs(got["pixel_accuracy"] - want["pixel_accuracy"]) <= 1e-6
    out = os.path.join(str(tmp_path / "port"), "run", "evaluation",
                       "final-group")
    with open(os.path.join(out, "iou_scores.json")) as f:
        assert list(json.load(f)) == jeval.class_names("pascal", 21)


def test_pascal_eval_test_matches_jax_fp32_export(tiny_msc, pascal_root,
                                                  tmp_path, monkeypatch):
    Image = pytest.importorskip("PIL.Image")
    model, spec, variables, tm, tspec = tiny_msc
    monkeypatch.setattr(jeval_test, "load_model",
                        lambda *a, **k: (model, spec, variables))
    monkeypatch.setattr(teval_test, "load_model",
                        lambda *a, **k: (tm, tspec))
    jdir = jeval_test.run_evaluation(
        "run", "final-group", batch_size=2, pascal=True,
        data_root=pascal_root, results_root=str(tmp_path / "jax"),
        fp32=True)
    tdir = teval_test.main(["run", "final-group", "2", "--pascal",
                            "--data-root", pascal_root, "--results-root",
                            str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(p[:-4] for p in os.listdir(os.path.join(
        pascal_root, "img_with_margin_0", "test")))
    assert len(names) == len(TEST_SIZES)
    for name, (h, w) in zip(names, TEST_SIZES):
        got = read_png(os.path.join(tdir, f"{name}.png"))
        want = np.asarray(Image.open(os.path.join(jdir, f"{name}.png")))
        assert got.shape == want.shape == (h, w)
        assert set(np.unique(got)) <= set(range(21))
        np.testing.assert_array_equal(got, want, err_msg=name)
