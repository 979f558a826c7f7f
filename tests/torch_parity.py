"""Shared helpers for the JAX-vs-port parity tests (tests/test_torch_*.py).

The JAX side builds a model, fills it with ``synthetic_init`` and hands
its numpy params to the port's weight carry; the port loads the result
with ``strict=True``.  Inputs cross as numpy arrays.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship, synthetic_init
from scaleprotoseg_torch.checkpoints.convert import (ppnet_params_to_statedict,
                                                     to_tensors)
from scaleprotoseg_torch.models.deeplab import DeepLabV2 as TDeepLabV2
from scaleprotoseg_torch.models.ppnet import PPNet as TPPNet
from scaleprotoseg_torch.spec import ProtoSpec as TProtoSpec


def port_spec(spec) -> TProtoSpec:
    """The port's ProtoSpec with the same fields as a JAX ProtoSpec."""
    return TProtoSpec(num_classes=spec.num_classes,
                      num_scales=spec.num_scales,
                      proto_depth=spec.proto_depth,
                      class_ids=tuple(spec.class_ids),
                      scale_bounds=tuple(spec.scale_bounds),
                      num_groups=spec.num_groups)


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def jax_flagship(grouped: bool = True, side: int = 33, seed: int = 0,
                 quant8=False):
    """Tiny-depth flagship (full widths) in float32 with synthetic weights:
    (model, spec, variables); ``quant8`` as the JAX package's (the
    variables hold no ``quant_scales``: they come from calibration)."""
    model, spec = _flagship(tiny=True, grouped=grouped, dtype=jnp.float32,
                            quant8=quant8)
    x = jnp.zeros((1, side, side, 3), jnp.float32)
    shapes = dict(jax.eval_shape(lambda k: model.init(k, x),
                                 jax.random.PRNGKey(0)))
    shapes.pop("quant_scales", None)
    return model, spec, synthetic_init(shapes, seed=seed)


def port_model(model, spec, variables, quant8=False) -> TPPNet:
    """The port's counterpart of a JAX DeepLabV2 PPNet, weights carried
    over by ``ppnet_params_to_statedict`` with ``strict=True``; ``quant8``
    builds the backbone's layer4/5 as int8 convs."""
    bb = model.backbone
    backbone = TDeepLabV2(n_out=bb.n_out, n_blocks=tuple(bb.n_blocks),
                          atrous_rates=tuple(bb.atrous_rates),
                          aspp_mode=bb.aspp_mode, quant8=quant8)
    tspec = port_spec(spec)
    tm = TPPNet(backbone, tspec, add_on_type=model.add_on_type,
                activation_fn=model.activation_fn, grouped=model.grouped)
    params = to_numpy_tree(variables["params"])
    stats = to_numpy_tree(variables.get("batch_stats", {}))
    sd = ppnet_params_to_statedict(params, stats, tspec)
    tm.load_state_dict(to_tensors(sd), strict=True)
    return tm.eval()


def labels_equal_outside_ties(got: np.ndarray, want: np.ndarray,
                              up_logits: np.ndarray, margin: float = 1e-5):
    """Labels must agree wherever the top-two margin of the reference's
    upsampled logits is at least ``margin``."""
    top2 = np.sort(up_logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= margin
    assert decided.mean() > 0.9, "too few decided pixels to compare"
    np.testing.assert_array_equal(got[decided], want[decided])
