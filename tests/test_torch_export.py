"""The port's serving artifact (``serving/export.py``) against the JAX
package's ``jax.export`` artifact, the serve CLI's artifact, canvas and
margin forms against the JAX package's CLI, and eval's sample renders and
distance histogram; on the CPU.

Models: the tiny-depth flagship (full widths) at 33 x 33 with
``synthetic_init`` weights carried over by the weight carry, except one
full-depth round trip through a run directory.  The JAX side runs on the
CPU (the XLA path, no Pallas), as its own ``tests/test_serving.py``.
Labels are held with ``labels_equal_outside_ties`` (top-two margin 1e-5 of
the JAX package's upsampled logits), logits at rtol 1e-4, atol 1e-4 of
their scale (``test_torch_model.py``); artifacts of the port against the
port's eager forward bit for bit.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scaleprotoseg_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from scaleprotoseg_torch.model_loading import calibrate_quant_scales
from scaleprotoseg_torch.models.layers import cast_convs
from scaleprotoseg_torch.serving.export import (export_serving,
                                                load_artifact,
                                                make_serving_fn,
                                                save_artifact)
from torch_parity import jax_flagship, labels_equal_outside_ties, port_model

SIDE = 33
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_OPS = {"scaleprotoseg.fused_aspp.default",
              "scaleprotoseg.fused_proto_logits.default",
              "scaleprotoseg.fused_upsample_argmax.default"}
INT8_OPS = {"scaleprotoseg.int8_mm.default",
            "scaleprotoseg.int8_conv3x3.default",
            "scaleprotoseg.quantize_int8.default"}


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, spec, variables, port model) of the tiny flagship."""
    model, spec, variables = jax_flagship(side=SIDE)
    return model, spec, variables, port_model(model, spec, variables)


@pytest.fixture(scope="module")
def u8_artifact(tiny, tmp_path_factory):
    """The tiny flagship's fixed-batch float32 artifact with the
    normalization inside (uint8 input), saved once for the tests that only
    load it."""
    tm = tiny[3]
    path = str(tmp_path_factory.mktemp("u8") / "art")
    save_artifact(path, export_serving(
        tm, height=SIDE, width=SIDE, batch=2, input_dtype=torch.float32,
        device_preprocess=True), spec=tm.spec)
    return path


def _images(n, seed=0, side=SIDE):
    return np.random.default_rng(seed).standard_normal(
        (n, side, side, 3)).astype(np.float32)


def _raw(n, seed=0, h=SIDE, w=SIDE):
    return np.random.default_rng(seed).integers(
        0, 256, (n, h, w, 3)).astype(np.uint8)


def _normalize(raw):
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (raw.astype(np.float32) / 255.0 - mean) / std


def _jax_up(model, variables, x, quant_model=None):
    from scaleprotoseg_tpu.serving.export import make_serving_fn as jfn
    fn = jfn(quant_model or model, output="logits")
    return np.asarray(jax.jit(fn)(variables, jnp.asarray(x)))


def _ops(exported):
    return {str(n.target) for n in exported.graph.nodes
            if str(n.target).startswith("scaleprotoseg.")}


def _jax_artifact(model, spec, variables, path, **kw):
    from scaleprotoseg_tpu.serving.export import export_serving as jexport
    from scaleprotoseg_tpu.serving.export import load_artifact as jload
    from scaleprotoseg_tpu.serving.export import save_artifact as jsave
    exported = jexport(model, variables, height=SIDE, width=SIDE,
                       input_dtype=jnp.float32, **kw)
    jsave(str(path), exported, variables, spec=spec)
    return jload(str(path))


@pytest.mark.parametrize("batch", [2, None], ids=["fixed", "dynamic"])
def test_plain_artifact_matches_jax_artifact(tiny, tmp_path, batch):
    """A fixed-batch and a symbolic-batch artifact of the plain path:
    ``load_artifact(...).predict`` against the JAX package's artifact of
    the same weights, with its shape guards."""
    model, spec, variables, tm = tiny
    want_art = _jax_artifact(model, spec, variables, tmp_path / "jax",
                             batch=batch)
    exported = export_serving(tm, height=SIDE, width=SIDE, batch=batch,
                              input_dtype=torch.float32)
    save_artifact(str(tmp_path / "port"), exported, spec=tm.spec,
                  extra={"note": "test"})
    assert sorted(os.listdir(tmp_path / "port")) == [
        "meta.json", "module.pt2", "weights.ckpt.json", "weights.pth"]
    served = load_artifact(str(tmp_path / "port"), device="cpu")
    assert served.input_shape == (batch, SIDE, SIDE, 3)
    assert served.input_dtype == torch.float32 and served.spec == tm.spec
    assert served.meta["platforms"] == ["cpu"]
    assert served.meta["output"] == {"shape": [batch, SIDE, SIDE],
                                     "dtype": "uint8"}
    assert not _ops(exported)              # the plain path holds no kernel
    for n in ((2,) if batch else (1, 3)):
        x = _images(n, seed=n)
        got = served.predict(torch.from_numpy(x)).numpy()
        want = np.asarray(want_art.predict(x))
        assert got.shape == want.shape == (n, SIDE, SIDE)
        assert got.dtype == np.uint8
        labels_equal_outside_ties(got, want, _jax_up(model, variables, x))
    if batch:
        with pytest.raises(ValueError, match="batch"):
            served.predict(torch.from_numpy(_images(3)))
    with pytest.raises(ValueError, match="exported"):
        served.predict(torch.from_numpy(_images(2, side=17)))


def test_logits_artifact_matches_jax(tiny, tmp_path):
    """``output='logits'`` (not upsampled): the artifact's float32 map
    against the JAX package's at rtol 1e-4, atol 1e-4 of its scale."""
    from scaleprotoseg_tpu.serving.export import make_serving_fn as jfn
    model, spec, variables, tm = tiny
    x = _images(2, seed=4)
    exported = export_serving(tm, height=SIDE, width=SIDE, batch=2,
                              input_dtype=torch.float32, output="logits",
                              upsample=False)
    save_artifact(str(tmp_path), exported, spec=tm.spec)
    got = load_artifact(str(tmp_path), device="cpu").predict(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jfn(model, output="logits", upsample=False))(
        variables, jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_device_normalize_bit_parity(tiny, u8_artifact):
    """A uint8 artifact (normalization in the program) gives the same
    labels, bit for bit, as the forward of host-normalized float32 input
    (the host pipeline's float32 ops)."""
    _, _, _, tm = tiny
    raw = _raw(2, seed=21)
    served = load_artifact(u8_artifact, device="cpu")
    assert served.input_dtype == torch.uint8
    assert served.meta["input"]["device_normalize"] is True
    got = served.predict(torch.from_numpy(raw))
    host = make_serving_fn(tm)(torch.from_numpy(_normalize(raw)))
    assert torch.equal(got, host)


def test_kernel_path_exported_on_cpu(tiny, tmp_path):
    """A ``fast=True`` bf16 fixed-batch export of CPU tensors holds K1, K2
    and K3 as ``scaleprotoseg::`` ops (their packed weights as buffers),
    and equals the port's eager fast path bit for bit (on the CPU each op
    runs its plain version); saved, loaded and run once, the same."""
    model, spec, variables, _ = tiny
    tm = cast_convs(port_model(model, spec, variables), torch.bfloat16)
    tm.features.base.aspp.fast = True
    raw = torch.from_numpy(_raw(2, seed=5))
    eager = make_serving_fn(tm, fast=True, normalize_to=torch.bfloat16)(raw)
    exported = export_serving(tm, height=SIDE, width=SIDE, batch=2,
                              input_dtype=torch.bfloat16, fast=True,
                              device_preprocess=True)
    assert _ops(exported) == KERNEL_OPS
    assert {"model.k1_bank", "model.features.base.aspp.k2_wstack"} <= \
        set(exported.state_dict)
    assert not any(k.startswith(("k1_", "k2_")) for k in tm._buffers)
    assert torch.equal(exported.module()(raw), eager)
    save_artifact(str(tmp_path), exported, spec=tm.spec)
    served = load_artifact(str(tmp_path), device="cpu")
    assert torch.equal(served.predict(raw), eager)
    with pytest.raises(ValueError, match="fixed batch"):
        export_serving(tm, height=SIDE, width=SIDE, batch=None, fast=True)


def test_dynamic_quant8_artifact_matches_jax(tiny, tmp_path):
    """Dynamic quant8 composes with export (the JAX package's
    ``test_quant8_export_roundtrip``): the artifact equals the eager
    quant8 forward and agrees with the JAX package's quant8 artifact."""
    import dataclasses
    model, spec, variables, _ = tiny
    q8 = dataclasses.replace(model, backbone=dataclasses.replace(
        model.backbone, quant8=True))
    tq = port_model(model, spec, variables, quant8=True)
    x = _images(2, seed=10)
    exported = export_serving(tq, height=SIDE, width=SIDE, batch=2,
                              input_dtype=torch.float32)
    assert _ops(exported) == {"scaleprotoseg.int8_absmax.default"} | \
        INT8_OPS
    save_artifact(str(tmp_path / "port"), exported, spec=tq.spec,
                  extra={"quant8": True})
    served = load_artifact(str(tmp_path / "port"), device="cpu")
    got = served.predict(torch.from_numpy(x))
    assert torch.equal(got, make_serving_fn(tq)(torch.from_numpy(x)))
    want = _jax_artifact(q8, spec, variables, tmp_path / "jax", batch=2)
    labels_equal_outside_ties(got.numpy(), np.asarray(want.predict(x)),
                              _jax_up(model, variables, x, quant_model=q8))


def test_replaced_weights_repoint_the_artifact(tiny, u8_artifact, tmp_path):
    """Artifact A's ``weights.pth`` replaced by artifact B's (other seed,
    same shapes) predicts B's labels; a file of other shapes is refused."""
    from scaleprotoseg_torch.checkpoints.convert import (synthetic_state_dict,
                                                         to_tensors)
    model, spec, variables, tm = tiny
    tb = port_model(model, spec, variables)
    tb.load_state_dict(to_tensors(synthetic_state_dict(tb, seed=3)))
    shutil.copytree(u8_artifact, tmp_path / "a")
    save_artifact(str(tmp_path / "b"), export_serving(
        tb, height=SIDE, width=SIDE, batch=2, input_dtype=torch.float32,
        device_preprocess=True), spec=tb.spec)
    x = torch.from_numpy(_raw(2, seed=11))
    want_b = make_serving_fn(tb, normalize_to=torch.float32)(x)
    assert not torch.equal(
        make_serving_fn(tm, normalize_to=torch.float32)(x), want_b)
    shutil.copyfile(tmp_path / "b" / "weights.pth",
                    tmp_path / "a" / "weights.pth")
    assert torch.equal(load_artifact(str(tmp_path / "a"), "cpu").predict(x),
                       want_b)
    state = torch.load(tmp_path / "a" / "weights.pth", weights_only=True)
    key = "model.prototype_vectors"
    state[key] = state[key][:-1]
    torch.save(state, tmp_path / "a" / "weights.pth")
    with pytest.raises(ValueError, match="prototype_vectors"):
        load_artifact(str(tmp_path / "a"), "cpu")


def test_artifact_needs_the_card_unless_told(u8_artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_artifact(u8_artifact)


def test_fresh_process_load_imports_no_model_code(tiny, u8_artifact,
                                                  tmp_path):
    """As a user runs it: a new interpreter loads the artifact and serves
    one batch with ``scaleprotoseg_torch.models``, the config stack and
    JAX never imported."""
    _, _, _, tm = tiny
    raw = _raw(2, seed=12)
    np.save(tmp_path / "x.npy", raw)
    x_path, y_path = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    code = (
        "import json, sys, numpy as np, torch\n"
        "from scaleprotoseg_torch.serving.export import load_artifact\n"
        f"art = load_artifact({u8_artifact!r}, device='cpu')\n"
        f"y = art.predict(torch.from_numpy(np.load({x_path!r})))\n"
        f"np.save({y_path!r}, y.numpy())\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "scaleprotoseg_torch.serving.export" in mods
    assert not [m for m in mods if m.startswith(
        ("scaleprotoseg_torch.models", "scaleprotoseg_torch.configlib",
         "scaleprotoseg_tpu", "jax", "flax"))]
    want = make_serving_fn(tm, normalize_to=torch.float32)(
        torch.from_numpy(raw))
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want.numpy())


# ---------------------------------------------------------------------------
# the serve CLI, against the JAX package's, on one run's tiny models
# ---------------------------------------------------------------------------
@pytest.fixture
def loaders(tiny, monkeypatch):
    """Both packages' ``load_model`` hand back the tiny flagship (the
    port's built anew per call: calibration writes into it)."""
    import scaleprotoseg_tpu.model_loading as jml
    import scaleprotoseg_torch.model_loading as tml
    model, spec, variables, _ = tiny

    def port_load(path, ckpt, dtype=torch.float32, fast=False, device=None,
                  quant8=False):
        tm = port_model(model, spec, variables, quant8=quant8)
        return tm, tm.spec

    monkeypatch.setattr(jml, "load_model",
                        lambda *a, **k: (model, spec, variables))
    monkeypatch.setattr(jml, "resolve_checkpoint", lambda *a: "ckpt")
    monkeypatch.setattr(tml, "load_model", port_load)
    monkeypatch.setattr(tml, "resolve_checkpoint", lambda *a: "ckpt")
    return tiny


def _write_images(d, shapes, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, (h, w) in shapes.items():
        np.save(os.path.join(d, f"{name}.npy"),
                rng.integers(0, 256, (h, w, 3)).astype(np.uint8))


def _both(tmp_path, args, port_args=("--device", "cpu")):
    from scaleprotoseg_tpu.serving.serve import main as jmain
    from scaleprotoseg_torch.serving.serve import main as tmain
    rj = jmain([*args(tmp_path / "jax"), "--raw-output"])
    rt = tmain([*args(tmp_path / "port"), "--raw-output", *port_args])
    return rj, rt


def test_serve_cli_export_then_artifact(loaders, tmp_path):
    """``--export`` writes the artifact and its record line; ``--artifact``
    serves it: labels against the JAX package's ``--export`` /
    ``--artifact`` on the same weights and images."""
    from scaleprotoseg_tpu.serving.serve import main as jmain
    from scaleprotoseg_torch.serving.serve import main as tmain
    model, _, variables, _ = loaders
    images = str(tmp_path / "images")
    _write_images(images, {f"f{i}": (SIDE, SIDE) for i in range(3)}, seed=3)
    common = ["run", "final", "--input", images, "--batch", "2",
              "--results-root", str(tmp_path)]
    rj = jmain([*common, "--export", str(tmp_path / "jart")])
    rt = tmain([*common, "--export", str(tmp_path / "tart"),
                "--device", "cpu"])
    assert rt == {"exported": str(tmp_path / "tart"),
                  "input": rj["input"], "platforms": ["cpu"]}
    assert rt["input"] == [2, SIDE, SIDE, 3]
    outs = {}
    for name, art, main, extra in (
            ("jax", "jart", jmain, []),
            ("port", "tart", tmain, ["--device", "cpu"])):
        rec = main(["--artifact", str(tmp_path / art),
                    "--input", images, "--output", str(tmp_path / name),
                    "--raw-output", *extra])
        assert rec["images"] == 3 and rec["preprocess"] == "device"
        outs[name] = [np.load(tmp_path / name / f"f{i}.npy")
                      for i in range(3)]
    raw = np.stack([np.load(os.path.join(images, f"f{i}.npy"))
                    for i in range(3)])
    up = _jax_up(model, variables, _normalize(raw))
    for i in range(3):
        labels_equal_outside_ties(outs["port"][i], outs["jax"][i], up[i])
    with pytest.raises(SystemExit):     # the artifact sets the preprocess
        tmain(["--artifact", str(tmp_path / "tart"), "--input", images,
               "--host-preprocess", "--device", "cpu"])


def test_serve_cli_canvas_mixed_sizes(loaders, tmp_path):
    """``--canvas``: each image bottom/right-padded to the canvas, its
    prediction cropped back; against the JAX package's ``--canvas`` on the
    same directory, and the padded image's prediction cropped equals the
    file; an image larger than the canvas is refused."""
    from scaleprotoseg_torch.serving.serve import _make_preprocess
    model, _, variables, tm = loaders
    shapes = {"a": (33, 33), "b": (17, 25), "c": (29, 13)}
    images = str(tmp_path / "images")
    _write_images(images, shapes, seed=9)

    def args(out):
        return ["run", "final", "--input", images, "--output", str(out),
                "--batch", "2", "--canvas", "33", "33",
                "--results-root", str(tmp_path)]

    rj, rt = _both(tmp_path, args)
    assert rj["images"] == rt["images"] == 3 and rt["preprocess"] == "host"
    pre = _make_preprocess(images, canvas=(SIDE, SIDE), sizes={})
    padded = np.stack([pre(f"{n}.npy") for n in shapes])
    up = _jax_up(model, variables, padded)
    eager = make_serving_fn(tm)(torch.from_numpy(padded)).numpy()
    for i, (name, (h, w)) in enumerate(shapes.items()):
        got = np.load(tmp_path / "port" / f"{name}.npy")
        assert got.shape == (h, w)
        np.testing.assert_array_equal(got, eager[i, :h, :w])
        labels_equal_outside_ties(
            got, np.load(tmp_path / "jax" / f"{name}.npy"), up[i, :h, :w])
    _write_images(images, {"d": (50, 20)}, seed=10)
    with pytest.raises(ValueError, match="larger than the"):
        _both(tmp_path, args)


def test_serve_cli_margin(loaders, tmp_path):
    """``--margin 2`` serves the 37 x 37 images' 33 x 33 centres, as the
    JAX package's ``--margin``."""
    model, _, variables, _ = loaders
    images = str(tmp_path / "images")
    _write_images(images, {f"m{i}": (37, 37) for i in range(2)}, seed=13)

    def args(out):
        return ["run", "final", "--input", images, "--output", str(out),
                "--batch", "2", "--margin", "2",
                "--results-root", str(tmp_path)]

    _both(tmp_path, args)
    raw = np.stack([np.load(os.path.join(images, f"m{i}.npy"))
                    for i in range(2)])[:, 2:-2, 2:-2]
    up = _jax_up(model, variables, _normalize(raw))
    for i in range(2):
        got = np.load(tmp_path / "port" / f"m{i}.npy")
        assert got.shape == (SIDE, SIDE)
        labels_equal_outside_ties(
            got, np.load(tmp_path / "jax" / f"m{i}.npy"), up[i])


def test_serve_cli_export_only_flags(loaders, tmp_path):
    """``--platforms`` and ``--dynamic-batch`` without ``--export`` are
    errors in both CLIs, as is ``--mesh 2`` in the port's; a
    ``--dynamic-batch`` export reports a null batch like its meta.json,
    and a ``--platforms cpu,cuda`` one names both."""
    from scaleprotoseg_tpu.serving.serve import main as jmain
    from scaleprotoseg_torch.serving.serve import main as tmain
    images = str(tmp_path / "images")
    _write_images(images, {"f0": (SIDE, SIDE)}, seed=5)
    common = ["run", "final", "--input", images,
              "--results-root", str(tmp_path)]
    for flag in (["--platforms", "cpu"], ["--dynamic-batch"]):
        for main in (jmain, tmain):
            with pytest.raises(SystemExit):
                main(common + flag)
    with pytest.raises(SystemExit):
        tmain(common + ["--mesh", "2", "--device", "cpu"])
    rj = jmain(common + ["--export", str(tmp_path / "jart"),
                         "--dynamic-batch"])
    rt = tmain(common + ["--export", str(tmp_path / "tart"),
                         "--dynamic-batch", "--device", "cpu"])
    assert rt["input"] == rj["input"] and rt["input"][0] is None
    assert load_artifact(str(tmp_path / "tart"), "cpu").input_shape[0] \
        is None
    rec = tmain(common + ["--export", str(tmp_path / "both"), "--platforms",
                          "cpu,cuda", "--device", "cpu"])
    assert rec["platforms"] == ["cpu", "cuda"]
    with open(tmp_path / "both" / "meta.json") as f:
        assert json.load(f)["platforms"] == ["cpu", "cuda"]


def test_static_quant8_artifact_ships_its_scales(loaders, tmp_path):
    """Static quant8 through the deploy one-liner ``export_from_run``: it
    needs calibration batches; the calibrated ``x_scale``s ship in
    ``weights.pth``, and the artifact serves the eager calibrated model's
    labels through the int8 ops without them."""
    from scaleprotoseg_torch.serving.export import export_from_run
    model, spec, variables, _ = loaders
    calib = [torch.from_numpy(_images(1, seed=s)) for s in (7, 8)]
    kw = dict(height=SIDE, width=SIDE, batch=2, quant8="static",
              input_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="calibration"):
        export_from_run("run", "ckpt", str(tmp_path / "none"), **kw)
    export_from_run("run", "ckpt", str(tmp_path / "art"), calibration=calib,
                    **kw)
    tq = port_model(model, spec, variables, quant8="static")
    calibrate_quant_scales(tq, calib)
    weights = torch.load(tmp_path / "art" / "weights.pth", weights_only=True)
    scales = {k: float(v) for k, v in weights.items()
              if k.endswith("x_scale")}
    sites = {f"model.{n}.x_scale": float(m.x_scale)
             for n, m in tq.named_modules() if hasattr(m, "x_scale")}
    assert scales == sites and min(scales.values()) > 0
    served = load_artifact(str(tmp_path / "art"), "cpu")
    assert served.meta["extra"]["quant8"] == "static"
    assert _ops(served.call) == INT8_OPS
    x = torch.from_numpy(_images(2, seed=9))
    assert torch.equal(served.predict(x), make_serving_fn(tq)(x))


def test_full_depth_run_dir_round_trip(tmp_path):
    """The full-depth flagship's run directory (written by the JAX package,
    as a user's): ``serve --export`` then ``serve --artifact`` give the
    run-dir serve's labels bit for bit."""
    from __graft_entry__ import _flagship, synthetic_init
    from scaleprotoseg_tpu.checkpoints.io import save_checkpoint
    from scaleprotoseg_tpu.convert_checkpoint import export_torch
    from scaleprotoseg_torch.serving.serve import main

    run = tmp_path / "results" / "city_run"
    model, spec = _flagship(tiny=False, grouped=True, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=1)
    ckpt = str(run / "checkpoints" / "push_final.ckpt")
    save_checkpoint(ckpt, variables["params"], variables["batch_stats"],
                    spec=spec, extra={"variant": "group"})
    export_torch(ckpt, str(run / "checkpoints" / "push_final.pth"))
    shutil.copyfile(os.path.join(REPO, "scaleprotoseg_tpu", "configs",
                                 "group_scaleproto_cityscapes.gin"),
                    run / "config.gin")
    images = str(tmp_path / "images")
    _write_images(images, {f"f{i}": (SIDE, SIDE) for i in range(2)}, seed=7)
    common = ["--input", images, "--batch", "2", "--raw-output",
              "--device", "cpu"]
    run_args = ["city_run", "push_final", "--results-root",
                str(tmp_path / "results")]
    main([*run_args, *common, "--output", str(tmp_path / "run")])
    main([*run_args, *common, "--export", str(tmp_path / "art")])
    rec = main(["--artifact", str(tmp_path / "art"), *common, "--output",
                str(tmp_path / "served")])
    assert rec["images"] == 2 and rec["artifact"] == str(tmp_path / "art")
    for i in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / "served" / f"f{i}.npy"),
            np.load(tmp_path / "run" / f"f{i}.npy"))


# ---------------------------------------------------------------------------
# eval's sample renders and distance histogram
# ---------------------------------------------------------------------------
def test_tab20_is_matplotlibs():
    pytest.importorskip("matplotlib")
    from matplotlib import cm

    from scaleprotoseg_torch.imageio import TAB20_LUT, tab20
    np.testing.assert_array_equal(TAB20_LUT[:20, :3],
                                  np.asarray(cm.tab20.colors))
    x = torch.linspace(-0.05, 1.05, 2201, dtype=torch.float64)
    x[7] = float("nan")
    np.testing.assert_array_equal(tab20(x).numpy(), cm.tab20(x.numpy()))


def test_sample_render_panels(tiny, tmp_path):
    """``_save_sample_artifacts`` on a Cityscapes-layout val root: each of
    the first 5 files renders input | ground truth | prediction, the input
    as it is, each label panel ``cm.tab20(Normalize(vmin, vmax)(labels),
    bytes=True)`` over its own minimum and maximum (the ground truth
    through the JAX package's label table and PIL-nearest resize, the
    prediction + 1 at the output grid)."""
    pytest.importorskip("matplotlib")
    from matplotlib import cm, colors

    from scaleprotoseg_tpu.constants import convert_targets
    from scaleprotoseg_tpu.ops.resize import resize_label_nearest_np
    from scaleprotoseg_torch.eval_valid_multiscale import \
        _save_sample_artifacts
    from scaleprotoseg_torch.imageio import read_png
    _, _, _, tm = tiny
    root = tmp_path / "city"
    rng = np.random.default_rng(6)
    files = [f"val_{i}" for i in range(6)]
    for sub in ("img_with_margin_0/val", "annotations/val"):
        (root / sub).mkdir(parents=True)
    for name in files:
        np.save(root / "img_with_margin_0/val" / f"{name}.npy",
                rng.integers(0, 256, (SIDE, 41, 3), dtype=np.uint8))
        np.save(root / "annotations/val" / f"{name}.npy",
                rng.integers(0, 34, (SIDE, 41), dtype=np.uint8))
    _save_sample_artifacts(tm, files, str(root / "img_with_margin_0/val"),
                           str(root / "annotations/val"), "cityscapes", 0,
                           str(tmp_path / "out"), torch.float32)
    written = sorted(os.listdir(tmp_path / "out" / "samples"))
    assert written == [f"{n}.png" for n in files[:5]]

    def tab20(labels):
        norm = colors.Normalize(labels.min(), labels.max())
        return cm.tab20(norm(labels), bytes=True)[..., :3]

    for name in files[:5]:
        img = np.load(root / "img_with_margin_0/val" / f"{name}.npy")
        x = torch.from_numpy(_normalize(img))[None]
        with torch.no_grad():
            pred = tm(x).logits[0].argmax(-1).numpy() + 1
        ann = convert_targets(np.load(root / "annotations/val" /
                                      f"{name}.npy"), "cityscapes")
        target = resize_label_nearest_np(ann.astype(np.int64),
                                         (pred.shape[1], pred.shape[0]))
        png = read_png(str(tmp_path / "out" / "samples" / f"{name}.png"))
        h, w = pred.shape
        assert png.shape == (SIDE, 41 + 8 + w + 8 + w, 3)
        np.testing.assert_array_equal(png[:, :41], img)
        np.testing.assert_array_equal(png[:h, 49:49 + w], tab20(target))
        np.testing.assert_array_equal(png[:h, 57 + w:], tab20(pred))
        assert (png[h:, 49:] == 255).all() and (png[:, 41:49] == 255).all()


def test_distance_histogram_matches_jax(tiny, tmp_path, monkeypatch):
    """The same-class squared distances behind ``proto_distance_hist.png``
    equal the JAX package's ``_save_plots`` numbers on the same
    prototypes (atol 1e-5); the port writes the histogram where
    matplotlib imports."""
    pytest.importorskip("matplotlib")
    from matplotlib.axes import Axes

    from scaleprotoseg_tpu.eval_valid_multiscale import \
        _save_plots as jplots
    from scaleprotoseg_torch.eval_valid_multiscale import (
        _save_plots, same_class_distances)
    _, spec, variables, tm = tiny
    caught = []
    real = Axes.hist
    monkeypatch.setattr(Axes, "hist", lambda self, x, *a, **k: (
        caught.append(np.asarray(x)), real(self, x, *a, **k))[1])
    os.makedirs(tmp_path / "jax")
    jplots(str(tmp_path / "jax"), {"a": 0.5}, variables, spec)
    got = same_class_distances(tm.prototypes().detach(), tm.spec).numpy()
    assert len(caught) == 1 and got.shape == caught[0].shape
    np.testing.assert_allclose(got, caught[0], rtol=0, atol=1e-5)
    os.makedirs(tmp_path / "port")
    _save_plots(str(tmp_path / "port"), {"a": 0.5}, None, got)
    assert os.path.exists(tmp_path / "port" / "proto_distance_hist.png")
