"""``ops.gradconv.conv3x3_dilated`` and ``train.fast_gradconv`` against the
JAX package's ``ops/gradconv.py`` and ``DeepLabV2(fast_gradconv=True)``.

Inputs are seeded numpy arrays, NHWC/HWIO on the JAX side and NCHW/OIHW
in the port.  The bounds are ``tests/test_gradconv.py``'s: the hybrid
backward is the same sums in another order, float32 roundoff only.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from scaleprotoseg_tpu.models.deeplab import DeepLabV2 as JDeepLabV2
from scaleprotoseg_tpu.ops.gradconv import conv3x3_dilated as jconv
from scaleprotoseg_torch.checkpoints.convert import (ppnet_params_to_statedict,
                                                     to_tensors)
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.models.deeplab import DeepLabV2
from scaleprotoseg_torch.models.layers import ConvBN
from scaleprotoseg_torch.models.ppnet import PPNet
from scaleprotoseg_torch.ops.gradconv import conv3x3_dilated
from scaleprotoseg_torch.spec import ProtoSpec
from scaleprotoseg_torch.train.runner import PhaseTrainer, module_hparams
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

TINY_BLOCKS = (1, 1, 1, 1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_conv3x3_dilated_matches_jax(rng, dilation):
    x = rng.standard_normal((2, 17, 19, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 16)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, 17, 19, 16)).astype(np.float32)

    def loss(x, w):
        return jnp.vdot(jconv(x, w, dilation), dy)

    gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, w)

    tx = _nchw(x).contiguous(memory_format=torch.channels_last) \
        .requires_grad_()
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    y = conv3x3_dilated(tx, tw, dilation)
    want = F.conv2d(tx, tw, None, 1, dilation, dilation)
    assert torch.equal(y, want)
    y.backward(_nchw(dy))
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(gx).transpose(0, 3, 1, 2),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tw.grad.numpy(),
                               np.asarray(gw).transpose(3, 2, 0, 1),
                               rtol=2e-5, atol=2e-4)


def test_no_grad_runs_the_conv_alone():
    x = torch.randn(1, 4, 9, 9)
    w = torch.randn(4, 4, 3, 3)
    with torch.no_grad():
        y = conv3x3_dilated(x, w, 2)
    assert y.grad_fn is None
    assert torch.equal(y, F.conv2d(x, w, None, 1, 2, 2))
    with pytest.raises(ValueError, match="3x3"):
        conv3x3_dilated(x, torch.randn(4, 4, 1, 1), 1)
    with pytest.raises(ValueError, match="fast_grad"):
        ConvBN(4, 4, 3, stride=2, fast_grad=True)


@pytest.fixture(scope="module")
def backbones():
    """A tiny JAX fast backbone with its synthetic weights, and the port's
    with and without ``fast_gradconv`` on the converted ones."""
    model = JDeepLabV2(n_out=8, n_blocks=TINY_BLOCKS, aspp_mode="concat",
                       fast_gradconv=True)
    x = np.random.default_rng(3).standard_normal((1, 33, 33, 3)) \
        .astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    spec = ProtoSpec.equal_allocation(8, 8, num_classes=2, num_scales=4)
    sd = ppnet_params_to_statedict(
        {"backbone": jax.tree.map(np.asarray, variables["params"])},
        {"backbone": jax.tree.map(np.asarray, variables["batch_stats"])},
        spec, log=lambda _: None)
    sd = to_tensors({k.removeprefix("features.base."): v
                     for k, v in sd.items()})
    ports = {}
    for fast in (False, True):
        m = DeepLabV2(n_out=8, n_blocks=TINY_BLOCKS, aspp_mode="concat",
                      fast_gradconv=fast)
        m.load_state_dict(sd, strict=True)
        ports[fast] = m.to(memory_format=torch.channels_last)
    return model, variables, x, ports


def _port_grads(m, x):
    m.zero_grad(set_to_none=True)
    y = m(_nchw(x).contiguous(memory_format=torch.channels_last))
    (y ** 2).sum().backward()
    return y.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}


def test_fast_backbone_same_state_forward_and_close_grads(backbones):
    _, _, x, ports = backbones
    plain, fast = ports[False], ports[True]
    assert list(fast.state_dict()) == list(plain.state_dict())
    fast_convs = sorted(n for n, m in fast.named_modules()
                        if isinstance(m, ConvBN) and m.fast_grad)
    assert fast_convs == ["layer4.block1.conv3x3", "layer5.block1.conv3x3"]
    y_plain, g_plain = _port_grads(plain, x)
    y_fast, g_fast = _port_grads(fast, x)
    assert torch.equal(y_fast, y_plain)
    assert set(g_fast) == set(g_plain)
    for name, g in g_plain.items():
        np.testing.assert_allclose(g_fast[name].numpy(), g.numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)


def test_fast_backbone_matches_jax_fast_backbone(backbones):
    model, variables, x, ports = backbones

    def loss(params):
        y = model.apply({**variables, "params": params}, jnp.asarray(x))
        return jnp.sum(y ** 2), y

    (_, y_jax), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    y, got = _port_grads(ports[True], x)
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(y_jax).transpose(0, 3, 1, 2),
                               rtol=5e-4, atol=5e-5)
    spec = ProtoSpec.equal_allocation(8, 8, num_classes=2, num_scales=4)
    want = ppnet_params_to_statedict(
        {"backbone": jax.tree.map(np.asarray, grads)}, None, spec,
        log=lambda _: None)
    want = {k.removeprefix("features.base."): v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def test_trainer_binding_sets_fast_gradconv_on_layer4_and_layer5(tmp_path):
    spec = ProtoSpec.equal_allocation(8, 8, num_classes=2, num_scales=4)
    bindings = parse_config("train.fast_gradconv = True")
    model = PPNet(DeepLabV2(n_out=8, n_blocks=(1, 2, 1, 2)), spec)
    trainer = PhaseTrainer(model, spec, "multiscale", str(tmp_path),
                           module_hparams(bindings, "multiscale"), bindings,
                           torch.device("cpu"), log=lambda *a: None)
    base = trainer.model.features.base
    assert base.fast_gradconv is True
    fast = sorted(n for n, m in base.named_modules()
                  if isinstance(m, ConvBN) and m.fast_grad)
    assert fast == ["layer4.block1.conv3x3", "layer5.block1.conv3x3",
                    "layer5.block2.conv3x3"]
    with pytest.raises(ValueError, match="quant8"):
        DeepLabV2(n_out=8, n_blocks=TINY_BLOCKS, quant8=True,
                  fast_gradconv=True)
