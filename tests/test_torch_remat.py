"""``train.remat``: a micro-step whose forward runs under non-reentrant
checkpointing and is computed again in the backward.

Against the same step without it (the JAX package's own bounds,
``tests/test_train_steps.py::test_remat_step_matches_plain``: loss within
rel 1e-6, updated prototypes within rtol 1e-6, atol 1e-7), in the
prototype phase's warm-up and joint steps and in the group phase's joint
step (gradient mask and simplex projection after the backward); against
the JAX package's ``make_train_step`` at ``test_torch_train_step``'s
bounds; and the bf16 recipe with K2's plain versions on the CPU.
"""

import copy

import numpy as np
import pytest
import torch

from scaleprotoseg_torch.kernels import aspp as kaspp
from scaleprotoseg_torch.train import optim as toptim
from scaleprotoseg_torch.train import steps as tsteps
from scaleprotoseg_torch.train.state import TrainState
from test_torch_group import HP as GROUP_HP
from test_torch_group import WEIGHTS as GROUP_WEIGHTS
from test_torch_train_step import (HP, WEIGHTS, _batch, _pair,
                                   check_step_against_jax)
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import jax_flagship, port_model


@pytest.fixture(scope="module")
def plain_model():
    return _pair()[3]


@pytest.fixture(scope="module")
def group_model():
    model, spec, variables = jax_flagship(grouped=True)
    tm = port_model(model, spec, variables)
    tm.incorrect_strength = 0.0
    return tm


def _one_step(tm, variant, phase, remat, hp, weights):
    """A copy of ``tm`` after one updating micro-step: (loss, model)."""
    tm = copy.deepcopy(tm)
    opt = toptim.PhaseOptimizer(
        tm.named_parameters(), toptim.phase_groups(variant, phase, hp),
        iter_size=1, guard_nonfinite=50)
    grouped = variant == "group"
    step = tsteps.make_train_step(
        tsteps.LossWeights(**weights), grad_mask_last_group=grouped,
        project_group_simplex=grouped, remat=remat)
    x, y = _batch()
    m = step(TrainState(tm, opt), torch.from_numpy(x), torch.from_numpy(y))
    return float(m["loss"]), tm


def _assert_same_step(tm, variant, phase, hp, weights, names):
    (l0, m0), (l1, m1) = (_one_step(tm, variant, phase, r, hp, weights)
                          for r in (False, True))
    assert l1 == pytest.approx(l0, rel=1e-6)
    before, plain, remat = tm.state_dict(), m0.state_dict(), m1.state_dict()
    for name in names:
        assert not torch.equal(plain[name], before[name]), name
        np.testing.assert_allclose(remat[name].numpy(), plain[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("phase", [0, 1], ids=["warmup", "joint"])
def test_remat_step_matches_plain(plain_model, phase):
    _assert_same_step(plain_model, "multiscale", phase, HP, WEIGHTS,
                      ["prototype_vectors"])


def test_remat_group_step_matches_plain(group_model):
    glw = "last_layer_group.weight"
    _assert_same_step(group_model, "group", 1, GROUP_HP, GROUP_WEIGHTS,
                      [glw, "group_projection.0.weight"])


def test_remat_step_matches_jax():
    check_step_against_jax(1, remat=True)


def test_bf16_recipe_remat_step_on_cpu(plain_model, monkeypatch):
    """bf16 convs and K2's path (its plain versions on the CPU) with
    remat: finite steps; the ASPP Function runs in the forward and again
    in the recompute, and K2's packed weights are built once a set of
    weights (the cache holds across the recompute)."""
    tm = copy.deepcopy(plain_model).set_compute_dtype(torch.bfloat16)
    aspp = tm.features.base.aspp
    aspp.fast = True
    calls = {"function": 0, "pack": 0}
    forward = kaspp._TrainableASPP.forward
    pack = aspp._pack

    def counted_forward(*args):
        calls["function"] += 1
        return forward(*args)

    def counted_pack():
        calls["pack"] += 1
        return pack()

    monkeypatch.setattr(kaspp._TrainableASPP, "forward",
                        staticmethod(counted_forward))
    monkeypatch.setattr(aspp, "_pack", counted_pack)
    opt = toptim.PhaseOptimizer(tm.named_parameters(),
                                toptim.phase_groups("multiscale", 1, HP),
                                iter_size=1, guard_nonfinite=50)
    state = TrainState(tm, opt)
    step = tsteps.make_train_step(tsteps.LossWeights(**WEIGHTS), remat=True)
    x, y = _batch(seed=1)
    for _ in range(2):
        m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert np.isfinite(float(m["loss"]))
    assert calls == {"function": 4, "pack": 2}
    assert all(torch.isfinite(p).all() for p in tm.parameters())
