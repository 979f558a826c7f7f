"""The port's phase optimizer against the JAX package's optax chain.

Both run 12 micro-steps on one toy parameter tree with one parameter per
label, in the warm-up groups (weight decay on the ASPP) and the joint
groups (weight decay and the poly schedule), with ``iter_size`` 3, the
non-finite guard on, and a NaN in the gradients of micro-step 4.  The gradients are drawn with numpy and handed to both.
Parameters must agree within 1e-6 after every micro-step (float32 Adam
arithmetic in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_torch.train import optim as toptim

# port name -> JAX param path, one per label
NAMES = {
    "features.base.layer2.block1.reduce.conv.weight":
        ("backbone", "layer2", "block1", "reduce", "conv", "kernel"),
    "features.base.aspp.c0.weight": ("backbone", "aspp", "c0", "kernel"),
    "features.base.aspp.c0.bias": ("backbone", "aspp", "c0", "bias"),
    "prototype_vectors": ("prototype_vectors",),
    "features.base.layer2.block1.reduce.bn.weight":
        ("backbone", "layer2", "block1", "reduce", "bn", "scale"),
}
SHAPES = {"features.base.layer2.block1.reduce.conv.weight": (4, 3),
          "features.base.aspp.c0.weight": (5, 2),
          "features.base.aspp.c0.bias": (2,),
          "prototype_vectors": (6, 4),
          "features.base.layer2.block1.reduce.bn.weight": (3,)}
HP = dict(warm_lr_add_on=1e-2, warm_lr_protos=2e-2, warm_wd=5e-2,
          joint_lr_features=3e-3, joint_lr_add_on=1e-2, joint_lr_protos=2e-2,
          joint_wd=5e-2, last_layer_lr=1e-2)


def _nest(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


@pytest.mark.parametrize("phase", [0, 1])
def test_phase_optimizer_matches_optax(phase):
    rng = np.random.default_rng(3)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    steps, iter_size, nan_at = 12, 3, 4
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(steps)]
    grads[nan_at]["prototype_vectors"][1, 2] = np.nan

    groups_j = joptim.phase_groups("multiscale", phase, HP)
    groups_t = toptim.phase_groups("multiscale", phase, HP)
    assert {k: (g.lr, g.weight_decay, g.use_schedule)
            for k, g in groups_j.items()} == \
        {k: (g.lr, g.weight_decay, g.use_schedule)
         for k, g in groups_t.items()}
    trainable = [n for n in NAMES
                 if toptim.label_of_path(n) in groups_t]
    assert {toptim.label_of_path(n) for n in NAMES} == \
        {joptim.label_of_path(p) for p in NAMES.values()}

    # JAX: the trainer's optimizer over the trainable partition
    params_j = _nest({NAMES[n]: jnp.asarray(init[n]) for n in trainable})
    sched_j = joptim.poly_schedule(0.9, 5) if phase == 1 else None
    tx = joptim.make_phase_optimizer(groups_j, joptim.label_params(params_j),
                                     schedule=sched_j, iter_size=iter_size,
                                     guard_nonfinite=50)
    state = tx.init(params_j)
    update = jax.jit(tx.update)

    # port
    tparams = {n: torch.nn.Parameter(torch.from_numpy(init[n].copy()))
               for n in NAMES}
    sched_t = toptim.poly_schedule(0.9, 5) if phase == 1 else None
    opt = toptim.PhaseOptimizer(tparams.items(), groups_t, schedule=sched_t,
                                iter_size=iter_size, guard_nonfinite=50)
    for n, p in tparams.items():
        assert p.requires_grad == (n in trainable)

    for i in range(steps):
        g_j = _nest({NAMES[n]: jnp.asarray(grads[i][n]) for n in trainable})
        upd, state = update(g_j, state, params_j)
        params_j = jax.tree.map(lambda p, u: p + u, params_j, upd)
        with torch.no_grad():
            for n in trainable:
                tparams[n].grad.copy_(torch.from_numpy(grads[i][n]))
        opt.step()
        for n in trainable:
            want = np.asarray(_get(params_j, NAMES[n]))
            np.testing.assert_allclose(tparams[n].detach().numpy(), want,
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{n} after micro-step {i}")
    frozen = [n for n in NAMES if n not in trainable]
    for n in frozen:
        np.testing.assert_array_equal(tparams[n].detach().numpy(), init[n])
    # the NaN micro-step was dropped: 11 accepted of 12 -> 3 updates
    assert int(opt._updates.item()) == 3


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_optimizer_step_invalidates_weight_caches():
    """The fused update does not bump the parameters' version counters
    itself; after ``step`` a ``WeightCache`` over them must rebuild, or
    K2's forward would keep its first weight stack."""
    from scaleprotoseg_torch.models.layers import WeightCache
    p = torch.nn.Parameter(torch.ones(4))
    opt = toptim.PhaseOptimizer([("prototype_vectors", p)],
                                toptim.phase_groups("multiscale", 0, HP))
    cache, builds = WeightCache(), []
    cache.get([p], lambda: builds.append(1) or p.detach().clone())
    with torch.no_grad():
        p.grad.fill_(1.0)
    opt.step()
    assert not torch.equal(p.detach(), torch.ones(4))
    fresh = cache.get([p], lambda: builds.append(1) or p.detach().clone())
    assert len(builds) == 2 and torch.equal(fresh, p.detach())
