"""Serving end to end on the CPU: the port's ``serve.main --device cpu``
against the JAX package's ``serve.main`` on one run directory.

The JAX side writes the run directory the way a user would: the
full-depth flagship (grouped ScaleProtoSeg, ResNet-101, Cityscapes
config) with ``synthetic_init`` weights, ``save_checkpoint``, then
``convert_checkpoint.export_torch`` for the ``.pth`` the port reads, and
the experiment config as ``config.gin``.  Labels must agree wherever the
top-two margin of the JAX upsampled logits is at least 1e-5.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scaleprotoseg_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from scaleprotoseg_torch.serving.engine import ServingEngine
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import labels_equal_outside_ties

SIDE = 33
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scaleprotoseg_tpu", "configs",
    "group_scaleproto_cityscapes.gin")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    from __graft_entry__ import _flagship, synthetic_init
    from scaleprotoseg_tpu.checkpoints.io import save_checkpoint
    from scaleprotoseg_tpu.convert_checkpoint import export_torch

    root = tmp_path_factory.mktemp("results")
    run = root / "city_run"
    model, spec = _flagship(tiny=False, grouped=True, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=1)
    ckpt = str(run / "checkpoints" / "push_final.ckpt")
    save_checkpoint(ckpt, variables["params"], variables["batch_stats"],
                    spec=spec, extra={"variant": "group"})
    export_torch(ckpt, str(run / "checkpoints" / "push_final.pth"))
    shutil.copyfile(CONFIG, run / "config.gin")

    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(17)
    raw = rng.integers(0, 256, size=(3, SIDE, SIDE, 3)).astype(np.uint8)
    for i, img in enumerate(raw):
        np.save(images / f"frame_{i}.npy", img)
    return root, images, raw, model, variables


def _serve(main, root, images, out, extra=()):
    return main(["city_run", "push_final", "--input", str(images),
                 "--output", str(out), "--batch", "2", "--raw-output",
                 "--results-root", str(root), *extra])


@pytest.fixture(scope="module")
def port_serve(run_dir, tmp_path_factory):
    """The port's float32 serve of the run with ``--raw-output`` and PIL
    blocked (the card machine has none), shared by the two tests that
    read it: (record, output directory)."""
    import sys

    from scaleprotoseg_torch.serving.serve import main as port_main

    root, images, _, _, _ = run_dir
    out = tmp_path_factory.mktemp("port_serve") / "nopil"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "PIL", None)
        mp.setitem(sys.modules, "PIL.Image", None)
        rec = _serve(port_main, root, images, out, ("--device", "cpu"))
    return rec, out


def test_port_serve_matches_jax_serve(run_dir, port_serve, tmp_path):
    from scaleprotoseg_tpu.serving.export import make_serving_fn
    from scaleprotoseg_tpu.serving.serve import main as jax_main

    root, images, raw, model, variables = run_dir
    rec_j = _serve(jax_main, root, images, tmp_path / "jax")
    rec_t, port_out = port_serve
    assert rec_j["images"] == rec_t["images"] == 3
    assert rec_t["preprocess"] == "device" and rec_t["fast"] is False

    up = np.asarray(jax.jit(make_serving_fn(
        model, output="logits", normalize_to=jnp.float32))(variables, raw))
    for i in range(3):
        want = np.load(tmp_path / "jax" / f"frame_{i}.npy")
        got = np.load(port_out / f"frame_{i}.npy")
        assert got.shape == (SIDE, SIDE) and got.dtype == np.uint8
        labels_equal_outside_ties(got, want, up[i])


def test_serve_without_device_needs_cuda(run_dir, tmp_path, monkeypatch):
    from scaleprotoseg_torch.serving.serve import main as port_main

    root, images, _, _, _ = run_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _serve(port_main, root, images, tmp_path / "none")
    assert not (tmp_path / "none").exists()


def test_engine_order_and_tail_padding():
    seen = []

    def predict(x):
        seen.append(tuple(x[:, 0, 0, 0].tolist()))
        return x[:, 0, 0, 0] * 10

    imgs = np.arange(5, dtype=np.float32)[:, None, None, None] * \
        np.ones((5, 2, 2, 3), np.float32)
    engine = ServingEngine(predict, batch_size=2, preprocess=lambda i: imgs[i],
                           workers=3, device="cpu")
    out = list(engine.run((f"img{i}", i) for i in range(5)))
    assert [k for k, _ in out] == [f"img{i}" for i in range(5)]
    assert [float(v) for _, v in out] == [0.0, 10.0, 20.0, 30.0, 40.0]
    # three fixed-size batches; the last repeats its only item
    assert seen == [(0.0, 1.0), (2.0, 3.0), (4.0, 4.0)]


def test_engine_rejects_bad_batch():
    with pytest.raises(ValueError):
        ServingEngine(lambda x: x, batch_size=0, device="cpu")


def test_engine_defaults_to_the_card(monkeypatch):
    """Without ``device`` the engine runs on CUDA, and says so where
    there is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(lambda x: x, batch_size=2)
    assert ServingEngine(lambda x: x, 2, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("flag", ["--quant8-static", "--quant8"])
def test_port_quant8_serve_matches_jax_serve(run_dir, tmp_path, flag):
    """``serve.main`` with static (calibrated on the served images) and
    dynamic int8 layer4/5 on both sides: the port's labels agree with the
    JAX package's wherever the top-two margin of the JAX quant8 model's
    upsampled logits is at least 1e-5."""
    from scaleprotoseg_tpu.model_loading import calibrate_quant_scales
    from scaleprotoseg_tpu.serving.export import make_serving_fn
    from scaleprotoseg_tpu.serving.serve import main as jax_main
    from scaleprotoseg_torch.serving.serve import main as port_main

    root, images, raw, _, variables = run_dir
    rec_j = _serve(jax_main, root, images, tmp_path / "jax", (flag,))
    rec_t = _serve(port_main, root, images, tmp_path / "port",
                   (flag, "--device", "cpu"))
    quant8 = "static" if flag == "--quant8-static" else True
    assert rec_j["images"] == rec_t["images"] == 3
    assert rec_t["quant8"] == quant8 and rec_t["fast"] is False

    from __graft_entry__ import _flagship
    model, _ = _flagship(tiny=False, grouped=True, dtype=jnp.float32,
                         quant8=quant8)
    if quant8 == "static":
        mean, std = np.asarray(IMAGENET_MEAN), np.asarray(IMAGENET_STD)
        variables = calibrate_quant_scales(model, variables, [
            ((img.astype(np.float32) / 255.0 - mean) / std)
            .astype(np.float32)[None] for img in raw])
    up = np.asarray(jax.jit(make_serving_fn(
        model, output="logits", normalize_to=jnp.float32))(variables, raw))
    for i in range(3):
        want = np.load(tmp_path / "jax" / f"frame_{i}.npy")
        got = np.load(tmp_path / "port" / f"frame_{i}.npy")
        labels_equal_outside_ties(got, want, up[i])


def test_raw_output_serves_without_pil(port_serve):
    """``--raw-output`` writes ``.npy`` labels and needs no PIL: the card
    machine has none (the shared serve ran with PIL blocked)."""
    rec, out = port_serve
    assert rec["images"] == 3
    assert sorted(os.listdir(out)) == [
        f"frame_{i}.npy" for i in range(3)]
