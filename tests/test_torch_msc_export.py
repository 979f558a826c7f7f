"""The serving artifact of an MSC model (``serving/export.py``): the port
against the JAX package's ``export_serving``, and the port's kernel path
exported on the CPU against its eager forward; on the CPU.

The tiny grouped MSC flagship of ``test_torch_msc`` (full widths, ResNet
stages of one block each, the pyramid (0.5, 0.75)) at 33 x 33:

- plain artifacts at a fixed and a symbolic batch: labels against the JAX
  package's artifact of the same weights wherever its top-two margin is
  at least 1e-5, and (fixed batch) the logits of both packages' logits
  artifacts at rtol 1e-4, atol 1e-4 of their scale; the program's constants (the pyramid's resize matrices
  among them) are real tensors, not the fake tensors of the trace;
- a bf16 ``fast`` artifact and a static quant8 ``fast`` artifact with its
  calibrated scales: K2 three times (once a map), K1 and K3 once, the
  int8 ops in the quant8 one, and no cast node that casts a tensor to its
  own dtype (host work on every call); saved and loaded, labels
  bit-equal to the eager forward.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

import jax
import jax.numpy as jnp

from scaleprotoseg_torch.model_loading import (calibrate_quant_scales,
                                               quant_sites)
from scaleprotoseg_torch.models.layers import cast_convs
from scaleprotoseg_torch.serving.export import (export_serving,
                                                load_artifact,
                                                make_serving_fn,
                                                save_artifact)
from test_torch_msc import SIDE, _msc_pair
from torch_parity import labels_equal_outside_ties

CASTS = {"aten._to_copy.default", "aten.to.dtype", "aten.to.dtype_layout",
         "aten.to.device", "aten._to_copy"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _msc_pair(True)


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, SIDE, SIDE, 3)).astype(np.float32)


def _op_counts(exported):
    out = {}
    for n in exported.graph.nodes:
        t = str(n.target)
        if t.startswith("scaleprotoseg."):
            key = t.split(".")[1]
            out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("batch", [2, None], ids=["fixed", "dynamic"])
def test_msc_plain_artifact_matches_jax(pair, tmp_path, batch):
    from scaleprotoseg_tpu.serving.export import export_serving as jexport
    from scaleprotoseg_tpu.serving.export import load_artifact as jload
    from scaleprotoseg_tpu.serving.export import make_serving_fn as jfn
    from scaleprotoseg_tpu.serving.export import save_artifact as jsave
    model, spec, variables, tm = pair
    jsave(str(tmp_path / "jax"), jexport(
        model, variables, height=SIDE, width=SIDE, batch=batch,
        input_dtype=jnp.float32), variables, spec=spec)
    want_art = jload(str(tmp_path / "jax"))

    exported = export_serving(tm, height=SIDE, width=SIDE, batch=batch,
                              input_dtype=torch.float32)
    assert not _op_counts(exported)        # the plain path: no kernel op
    consts = {k: v for k, v in exported.constants.items()
              if isinstance(v, torch.Tensor)}
    assert not [k for k, v in consts.items() if isinstance(v, FakeTensor)]
    # the pyramid's factor matrices (33 -> 16 and 24) are among them
    shapes = {tuple(v.shape) for v in consts.values()}
    assert {(16, SIDE), (24, SIDE)} <= shapes
    save_artifact(str(tmp_path / "port"), exported, spec=tm.spec)
    served = load_artifact(str(tmp_path / "port"), device="cpu")
    assert served.input_shape == (batch, SIDE, SIDE, 3)
    up_fn = jax.jit(jfn(model, output="logits"))
    for n in ((2,) if batch else (1, 3)):
        x = _images(n, seed=n)
        got = served.predict(torch.from_numpy(x)).numpy()
        want = np.asarray(want_art.predict(x))
        assert got.shape == want.shape == (n, SIDE, SIDE)
        labels_equal_outside_ties(got, want,
                                  np.asarray(up_fn(variables,
                                                   jnp.asarray(x))))
    if batch is None:
        return
    # the logits (not upsampled) of both packages' artifacts, at the
    # tolerance of test_torch_export.py::test_logits_artifact_matches_jax
    kw = dict(height=SIDE, width=SIDE, batch=batch, output="logits",
              upsample=False)
    jsave(str(tmp_path / "jax_logits"), jexport(
        model, variables, input_dtype=jnp.float32, **kw), variables,
        spec=spec)
    save_artifact(str(tmp_path / "port_logits"), export_serving(
        tm, input_dtype=torch.float32, **kw), spec=tm.spec)
    x = _images(2, seed=4)
    want = np.asarray(jload(str(tmp_path / "jax_logits")).predict(x))
    got = load_artifact(str(tmp_path / "port_logits"), device="cpu") \
        .predict(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 5, 5, tm.spec.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("quant8", [False, "static"], ids=["bf16",
                                                           "quant8static"])
def test_msc_fast_artifact_bit_equal_on_cpu(tmp_path, quant8):
    """The kernel path exported on the CPU (each op runs its plain
    version there): one K2 node a pyramid map, K1 and K3 once; saved and
    loaded, the labels of the eager fast forward bit for bit."""
    _, _, _, tm = _msc_pair(True, quant8=quant8)
    tm = cast_convs(tm, torch.bfloat16)
    tm.features.base.aspp.fast = True
    x = torch.from_numpy(_images(2, seed=7)).to(torch.bfloat16)
    if quant8:
        calibrate_quant_scales(tm, [x[:1], x[1:]])
    eager = make_serving_fn(tm, fast=True)(x)
    exported = export_serving(tm, height=SIDE, width=SIDE, batch=2,
                              input_dtype=torch.bfloat16, fast=True)
    counts = _op_counts(exported)
    assert counts.pop("fused_aspp") == 3
    assert counts.pop("fused_proto_logits") == 1
    assert counts.pop("fused_upsample_argmax") == 1
    if quant8:
        # 8 sites a map: layer4's and layer5's blocks of one
        assert counts == {"int8_mm": 3 * 6, "int8_conv3x3": 3 * 2,
                          "quantize_int8": 3 * 8}
        scales = {f"model.{n}.x_scale" for n, _ in quant_sites(tm)}
        assert scales <= set(exported.constants) | set(
            exported.state_dict)
    else:
        assert not counts
    for n in exported.graph.nodes:
        if str(n.target) in CASTS:
            src = n.args[0].meta["val"]
            assert src.dtype != n.meta["val"].dtype, n.format_node()
    save_artifact(str(tmp_path), exported, spec=tm.spec)
    served = load_artifact(str(tmp_path), device="cpu")
    assert torch.equal(served.predict(x), eager)


def test_resize_matrices_go_to_the_device_once():
    """The pyramid's and the fused map's resize matrices are made once per
    size and device, not on every call (a host-to-device copy a call on
    the card), and a matrix first made while serving (inference mode)
    serves a training step too; while ``torch.export`` traces they are
    made anew (the test above holds the program's constants real)."""
    from scaleprotoseg_torch.ops import resize
    x = torch.rand((1, SIDE, SIDE, 3))
    resize._device_table.cache_clear()
    with torch.inference_mode():
        resize.resize_bilinear_factor(x, 0.5)
        resize.resize_bilinear(x, 65, 65)
    # square input: each call's row and column matrices are one
    first = resize._device_table.cache_info()
    assert first.misses == 2 and first.hits == 2
    xg = x.clone().requires_grad_(True)
    y = resize.resize_bilinear_factor(xg, 0.5).sum() + \
        resize.resize_bilinear(xg, 65, 65).sum()
    y.backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    again = resize._device_table.cache_info()
    assert again.misses == 2 and again.hits == 6
