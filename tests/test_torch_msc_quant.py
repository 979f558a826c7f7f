"""int8 serving of an MSC model: the port against the JAX package's, on
the CPU.

The tiny MSC flagship of ``test_torch_msc`` (full widths, ResNet stages of
one block each, the pyramid (0.5, 0.75)), plain and grouped, with layer4/5
built as int8 convs on both sides:

- static calibration: the pyramid calls the one backbone once per map, so
  each site folds the base map's and both pyramid maps' ``max|x| / 127``
  into its one ``x_scale``; every site's scale against the JAX package's
  ``calibrate_quant_scales`` on the same seeded batches (rtol 1e-6), and
  equal to the largest of the three maps calibrated alone;
- the quant8 forward, static (the JAX scales carried over) and dynamic:
  labels equal wherever the JAX package's top-two margin is at least
  1e-5, float32 logits within 1e-3, as ``test_torch_quant`` holds the
  model without the pyramid.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scaleprotoseg_tpu.model_loading import calibrate_quant_scales as jcal
from scaleprotoseg_tpu.serving import make_serving_fn as jfn
from scaleprotoseg_torch.checkpoints.convert import quant_scales_from_jax
from scaleprotoseg_torch.model_loading import (calibrate_quant_scales,
                                               quant_sites, set_quant_scales)
from scaleprotoseg_torch.ops.resize import resize_bilinear_factor
from scaleprotoseg_torch.serving.export import make_serving_fn
from test_torch_msc import SCALES, SIDE, _msc_pair
from torch_parity import labels_equal_outside_ties

GROUPED = pytest.mark.parametrize("grouped", [False, True],
                                  ids=["plain", "group"])


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(seed=3, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, SIDE, SIDE, 3)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def static_pairs():
    """{grouped: (JAX model, spec, variables with the calibrated
    ``quant_scales``, port model)} with static quant8."""
    out = {}
    for g in (False, True):
        model, spec, variables, tm = _msc_pair(g, quant8="static")
        variables = jcal(model, variables,
                         [jnp.asarray(b) for b in _batches()])
        out[g] = model, spec, variables, tm
    return out


@GROUPED
def test_msc_calibrated_scales_match_jax(static_pairs, grouped):
    _, _, variables, tm = static_pairs[grouped]
    want = quant_scales_from_jax(jax.tree.map(np.asarray,
                                              variables["quant_scales"]))
    lines = []
    calibrate_quant_scales(tm, (torch.from_numpy(b) for b in _batches()),
                           log=lines.append)
    got = {n: m.x_scale.item() for n, m in quant_sites(tm)}
    # layer4: one block (4 sites); layer5: one block (4 sites)
    assert len(got) == 8 and set(got) == set(want)
    assert lines and "8 conv sites" in lines[0]
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   err_msg=name)

    # one scale per site: the largest of the three maps' own calibrations
    maps = {}
    tm.msc_scales = ()
    try:
        for p in (1.0, *SCALES):
            for _, m in quant_sites(tm):
                m.x_scale.zero_()
            calibrate_quant_scales(tm, (
                torch.from_numpy(b) if p == 1.0 else
                resize_bilinear_factor(torch.from_numpy(b), p)
                for b in _batches()))
            maps[p] = {n: m.x_scale.item() for n, m in quant_sites(tm)}
    finally:
        tm.msc_scales = SCALES
        set_quant_scales(tm, got)
    for name in got:
        assert got[name] == max(maps[p][name] for p in maps), name
    # the three maps calibrate to different scales: the max is a real one
    assert all(any(maps[p][n] != maps[1.0][n] for n in got)
               for p in SCALES)


@GROUPED
@pytest.mark.parametrize("quant8", ["static", True], ids=["static",
                                                          "dynamic"])
def test_msc_quant8_forward_matches_jax(static_pairs, grouped, quant8):
    if quant8 == "static":
        model, _, variables, tm = static_pairs[grouped]
        set_quant_scales(tm, quant_scales_from_jax(jax.tree.map(
            np.asarray, variables["quant_scales"])))
    else:
        model, _, variables, tm = _msc_pair(grouped, quant8=True)
    x = np.random.default_rng(4).standard_normal(
        (2, SIDE, SIDE, 3)).astype(np.float32)
    want = np.asarray(jfn(model)(variables, jnp.asarray(x)))
    up = np.asarray(jfn(model, output="logits")(variables, jnp.asarray(x)))
    got = make_serving_fn(tm)(torch.from_numpy(x)).numpy()
    labels_equal_outside_ties(got, want, up)
    lj = np.asarray(jfn(model, output="logits", upsample=False)(
        variables, jnp.asarray(x)))
    lt = make_serving_fn(tm, output="logits", upsample=False)(
        torch.from_numpy(x)).numpy()
    assert lt.shape == lj.shape == (2, 5, 5, tm.spec.num_classes)
    np.testing.assert_allclose(lt, lj, atol=1e-3, rtol=0)
