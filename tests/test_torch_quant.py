"""The quant8 path of the port against the JAX package's, on the CPU.

The same numpy inputs go through ``scaleprotoseg_tpu.ops.quant`` and
``scaleprotoseg_torch.ops.quant``: the quantize and both int8 conv forms
must be bit-equal (the int32 accumulation is exact on both sides and the
rounding and dequantize are the same float32 ops).  On the tiny flagship
(full widths, float32, grouped) calibration must give the same per-site
scales, and quant8 serving the same labels wherever the top-two margin of
the JAX upsampled logits is at least 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from scaleprotoseg_torch.checkpoints.convert import (quant_scales_from_jax,
                                                     quant_scales_to_jax)
from scaleprotoseg_torch.kernels.int8 import (int8_conv3x3, int8_mm,
                                              quantize_int8)
from scaleprotoseg_torch.model_loading import (calibrate_quant_scales,
                                               quant_sites, set_quant_scales)
from scaleprotoseg_torch.ops import quant as tq
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import jax_flagship, labels_equal_outside_ties, port_model

SIDE = 33


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("axis", [None, 3, (0, 3)],
                         ids=["tensor", "channel", "two_axes"])
def test_quantize_symmetric_matches_jax(rng, axis):
    from scaleprotoseg_tpu.ops.quant import quantize_symmetric
    x = (rng.standard_normal((3, 5, 7, 4)) * 3).astype(np.float32)
    qj, sj = quantize_symmetric(jnp.asarray(x), axis=axis)
    qt, st = tq.quantize_symmetric(_t(x), axis=axis)
    assert qt.dtype == torch.int8 and tuple(st.shape) == tuple(sj.shape)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


CONVS = {"1x1": ((1, 1), (1, 1)), "3x3_d2": ((3, 3), (2, 2)),
         "3x3_d4": ((3, 3), (4, 4))}


@pytest.mark.parametrize("form", ["dynamic", "static"])
@pytest.mark.parametrize("conv", list(CONVS))
def test_int8_conv_matches_jax(rng, form, conv):
    """Bit-equal to the JAX package's conv, and the port's kernel dispatch
    (``int8_conv`` through the wrappers' plain versions) bit-equal to
    both.  The static scale sits below the input's range, so some values
    saturate."""
    from scaleprotoseg_tpu.ops import quant as jq
    (kh, kw), dil = CONVS[conv]
    x = (rng.standard_normal((2, 9, 11, 64)) * 2).astype(np.float32)
    w = (rng.standard_normal((kh, kw, 64, 128)) * 0.05).astype(np.float32)
    kw_ = dict(dilation=dil)
    if form == "dynamic":
        want = jq.dynamic_int8_conv(jnp.asarray(x), jnp.asarray(w), **kw_)
        got = tq.dynamic_int8_conv(_t(x), _t(w), **kw_)
        scale = None
    else:
        s = np.float32(np.abs(x).max() / 127 * 0.8)
        want = jq.static_int8_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.float32(s), **kw_)
        got = tq.static_int8_conv(_t(x), _t(w), torch.tensor(s), **kw_)
        scale = torch.tensor(s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    disp = tq.int8_conv(_t(x), tq.pack_int8_weight(_t(w)), scale, dil[0])
    np.testing.assert_array_equal(disp.numpy(), got.numpy())


def _conv_fp32(x, w, dilation):
    return lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME", rhs_dilation=dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("form", ["dynamic", "static"])
def test_int8_conv_exact_when_representable(rng, form):
    """Values on the int8 grid quantize losslessly, so the int8 conv equals
    the float32 conv exactly (the oracle of ``tests/test_quant.py``)."""
    xi = rng.integers(-127, 128, size=(2, 9, 9, 8))
    xi[0, 0, 0, 0] = 127
    wi = rng.integers(-127, 128, size=(3, 3, 8, 16))
    wi[0, 0, 0, :] = 127
    sx = 0.0625                              # powers of two: exact in fp
    sw = np.full(16, 0.03125)
    sw[3] = 0.125                            # distinct per-channel scales
    x = (xi * sx).astype(np.float32)
    w = (wi * sw).astype(np.float32)
    if form == "dynamic":
        got = tq.dynamic_int8_conv(_t(x), _t(w), dilation=(2, 2))
    else:
        got = tq.static_int8_conv(_t(x), _t(w), torch.tensor(sx),
                                  dilation=(2, 2))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_conv_fp32(x, w, (2, 2))))


def test_int8_wrappers_plain_versions(rng):
    """On CPU tensors the wrappers run their plain versions: exact int32
    products, the static quantize by the reciprocal and the dynamic one by
    division, both half to even."""
    a = _t(rng.integers(-127, 128, size=(70, 64)).astype(np.int8))
    bt = _t(rng.integers(-127, 128, size=(128, 64)).astype(np.int8))
    acc = int8_mm(a, bt)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), a.numpy().astype(np.int64) @ bt.numpy().T.astype(
            np.int64))
    sx, sw = torch.tensor(0.5), torch.full((128,), 0.25)
    np.testing.assert_array_equal(
        int8_mm(a, bt, sx, sw, torch.float32).numpy(),
        acc.numpy().astype(np.float32) * np.float32(0.125))
    x = _t(rng.integers(-127, 128, size=(1, 6, 7, 64)).astype(np.int8))
    wt = _t(rng.integers(-127, 128, size=(9, 128, 64)).astype(np.int8))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(
            wt.numpy().reshape(3, 3, 128, 64).transpose(0, 1, 3, 2)),
        (1, 1), "SAME", rhs_dilation=(2, 2),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(int8_conv3x3(x, wt, 2).numpy(), want)
    v = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 0.49])
    np.testing.assert_array_equal(
        quantize_int8(v, torch.tensor(1.0), divide=True).numpy(),
        [0, 2, 2, 0, -2, 127, -127, 0])


@pytest.fixture(scope="module")
def tiny_static():
    """The tiny flagship with static quant8 on both sides, and two
    calibration batches."""
    model, spec, variables = jax_flagship(side=SIDE, quant8="static")
    rng = np.random.default_rng(3)
    batches = [rng.standard_normal((1, SIDE, SIDE, 3)).astype(np.float32)
               for _ in range(2)]
    return model, spec, variables, batches


def test_calibrated_scales_match_jax(tiny_static):
    from scaleprotoseg_tpu.model_loading import calibrate_quant_scales as jcal
    model, spec, variables, batches = tiny_static
    jq = jcal(model, variables, [jnp.asarray(b) for b in batches])
    want = quant_scales_from_jax(jax.tree.map(np.asarray,
                                              jq["quant_scales"]))
    tm = port_model(model, spec, variables, quant8="static")
    lines = []
    calibrate_quant_scales(tm, (_t(b) for b in batches), log=lines.append)
    got = {n: m.x_scale.item() for n, m in quant_sites(tm)}
    # layer4: 2 blocks (4 + 3 sites); layer5: 1 block (4 sites)
    assert len(got) == 11 and set(got) == set(want)
    assert all(v > 0 for v in got.values())
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5)
    assert lines and "11 conv sites" in lines[0]
    # the carry back gives the JAX tree's structure
    back = quant_scales_to_jax(got)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree.map(np.asarray,
                                                  jq["quant_scales"]))


def test_calibration_only_raises_scales(tiny_static):
    model, spec, variables, batches = tiny_static
    tm = port_model(model, spec, variables, quant8="static")
    calibrate_quant_scales(tm, [_t(batches[0])])
    first = {n: m.x_scale.item() for n, m in quant_sites(tm)}
    calibrate_quant_scales(tm, [_t(batches[0] * 0.5)])
    for n, m in quant_sites(tm):
        assert m.x_scale.item() == first[n]
    with pytest.raises(ValueError, match="no calibration batches"):
        calibrate_quant_scales(tm, iter(()))


@pytest.mark.parametrize("quant8", ["static", True], ids=["static",
                                                          "dynamic"])
def test_quant8_serving_matches_jax(tiny_static, quant8):
    """Static with the scales carried over from JAX, and dynamic: labels
    equal outside near-ties, float32 logits within 1e-3 (an input that
    lands on the other side of a rounding boundary moves one int8 step)."""
    from scaleprotoseg_tpu.model_loading import calibrate_quant_scales as jcal
    from scaleprotoseg_tpu.serving import make_serving_fn as jfn
    from scaleprotoseg_torch.serving.export import make_serving_fn
    _, spec, variables, batches = tiny_static
    model, _, _ = jax_flagship(side=SIDE, quant8=quant8)
    tm = port_model(model, spec, variables, quant8=quant8)
    if quant8 == "static":
        variables = jcal(model, variables, [jnp.asarray(b) for b in batches])
        set_quant_scales(tm, quant_scales_from_jax(jax.tree.map(
            np.asarray, variables["quant_scales"])))
    x = np.random.default_rng(4).standard_normal(
        (2, SIDE, SIDE, 3)).astype(np.float32)
    want = np.asarray(jfn(model)(variables, jnp.asarray(x)))
    up = np.asarray(jfn(model, output="logits")(variables, jnp.asarray(x)))
    got = make_serving_fn(tm)(_t(x)).numpy()
    labels_equal_outside_ties(got, want, up)
    lj = np.asarray(jfn(model, output="logits", upsample=False)(
        variables, jnp.asarray(x)))
    lt = make_serving_fn(tm, output="logits", upsample=False)(_t(x)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-3, rtol=0)


def test_uncalibrated_static_model_refuses_to_serve(tiny_static):
    from scaleprotoseg_torch.serving.export import make_serving_fn
    model, spec, variables, batches = tiny_static
    tm = port_model(model, spec, variables, quant8="static")
    with pytest.raises(ValueError, match="calibrate"):
        make_serving_fn(tm)(_t(batches[0]))


def test_dynamic_quant8_serves_without_fast(tiny_static):
    """``make_serving_fn`` drops ``fast`` for a dynamic quant8 model, as
    the JAX package's does: fast=True gives the fast=False labels."""
    from scaleprotoseg_torch.serving.export import make_serving_fn
    _, spec, variables, batches = tiny_static
    model, _, _ = jax_flagship(side=SIDE, quant8=True)
    tm = port_model(model, spec, variables, quant8=True)
    x = _t(batches[1])
    np.testing.assert_array_equal(make_serving_fn(tm, fast=True)(x).numpy(),
                                  make_serving_fn(tm, fast=False)(x).numpy())


def test_quant8_keeps_the_state_dict(tiny_static):
    model, spec, variables, _ = tiny_static
    plain = port_model(model, spec, variables).state_dict()
    for q in (True, "static"):
        sd = port_model(model, spec, variables, quant8=q).state_dict()
        assert list(sd) == list(plain)
    with pytest.raises(ValueError, match="quant8"):
        port_model(model, spec, variables, quant8="int4")


def test_train_step_refuses_quant8(tiny_static):
    from scaleprotoseg_torch.train.optim import OptimGroup, PhaseOptimizer
    from scaleprotoseg_torch.train.state import TrainState
    from scaleprotoseg_torch.train.steps import LossWeights, make_train_step
    model, spec, variables, batches = tiny_static
    tm = port_model(model, spec, variables, quant8="static")
    opt = PhaseOptimizer(tm.named_parameters(),
                         {"prototypes": OptimGroup(1e-3)})
    step = make_train_step(LossWeights())
    target = torch.ones((1, SIDE, SIDE), dtype=torch.int64)
    with pytest.raises(ValueError, match="quant8"):
        step(TrainState(tm, opt), _t(batches[0]), target)


def _write_run(root, arch: str) -> str:
    """A run directory with a ResNet-50 multiscale checkpoint (toy bank)
    whose config names ``arch``; returns the checkpoint path."""
    from scaleprotoseg_torch.checkpoints.convert import save_checkpoint
    from scaleprotoseg_torch.configlib import parse_config
    from scaleprotoseg_torch.models.factory import construct_ppnet
    from scaleprotoseg_torch.spec import ProtoSpec
    depth = "deeplabv2_resnet50_features_multiscale.deeplab_n_features = 64\n"
    spec = ProtoSpec.equal_allocation(8, 64, num_classes=2, num_scales=4)
    model, _ = construct_ppnet("multiscale", "deeplabv2_resnet50_multiscale",
                               (8, 64, 1, 1), 2, bindings=parse_config(depth),
                               spec=spec)
    (root / "config.gin").write_text(
        f"construct_PPNet.base_architecture = '{arch}'\n" + depth)
    stem = str(root / "checkpoints" / "toy")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    save_checkpoint(stem, sd, spec, extra={"variant": "multiscale"})
    return stem + ".pth"


def test_load_model_quant8_rejects_non_deeplab(tmp_path):
    from scaleprotoseg_torch.model_loading import load_model
    ckpt = _write_run(tmp_path, "unet")
    with pytest.raises(ValueError, match="quant8"):
        load_model(str(tmp_path), ckpt, quant8=True, device="cpu")


def test_load_model_quant8_fast_rule(tmp_path):
    """Dynamic quant8 drops the fast ASPP, static keeps it (the JAX
    package's rule, ``model_loading.py:138-153``)."""
    from scaleprotoseg_torch.model_loading import load_model
    ckpt = _write_run(tmp_path, "deeplabv2_resnet50_multiscale")
    for quant8, fast in ((True, False), ("static", True), (False, True)):
        model, _ = load_model(str(tmp_path), ckpt, fast=True, quant8=quant8,
                              device="cpu")
        assert model.features.base.quant8 == quant8
        assert model.features.base.aspp.fast is fast
    assert len(quant_sites(model)) == 0
