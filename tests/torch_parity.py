"""Shared helpers for the JAX-vs-port parity tests (tests/test_torch_*.py).

The JAX side builds a model, fills it with ``synthetic_init`` and hands
its numpy params to the port's weight carry; the port loads the result
with ``strict=True``.  Inputs cross as numpy arrays.
"""

from __future__ import annotations

import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship, synthetic_init
from scaleprotoseg_torch.kernels import proto as tproto
from scaleprotoseg_torch.checkpoints.convert import (ppnet_params_to_statedict,
                                                     to_tensors)
from scaleprotoseg_torch.models.deeplab import DeepLabV2 as TDeepLabV2
from scaleprotoseg_torch.models.ppnet import PPNet as TPPNet
from scaleprotoseg_torch.spec import ProtoSpec as TProtoSpec


@pytest.fixture(autouse=True, scope="module")
def own_sigterm_guard():
    """Import into a test module that runs the port's trainers: its
    trainers get a fresh SIGTERM guard, and the handler before it comes
    back after the module.  The guard's flag lives as long as its
    process, and a test of another file sends SIGTERM to its own process
    (the JAX package's preemption tests do, through a handler that
    chains to the port's), so a flag left set there would stop these
    trainers at their first step."""
    from scaleprotoseg_torch.train import preemption
    prev = signal.getsignal(signal.SIGTERM)
    preemption._guard = None
    yield
    preemption._guard = None
    signal.signal(signal.SIGTERM, prev)


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


def emulate_proto_kernel(feats, head, spec, pieces=3):
    """``csrc/proto.cu``'s arithmetic on the CPU, read from the packed head
    alone: per step the cross term as the bf16 pieces' products (exact
    products, lo first; ``pieces`` = 2 leaves lo out) summed and rounded
    to fp32, the reference
    formula for d and the activation, then the head tables walked as the
    kernel walks them (group: each half of a chunk's entries adds into
    registers and flushes a class run into its G scores; plain: each half
    of the pass's output columns), and each pass's logits written or
    added."""
    x = feats.reshape(-1, spec.feature_depth).float()
    n, c, g = x.shape[0], spec.num_classes, head.groups
    k = head.columns.shape[0]
    split = head.bank.reshape(k, 3, 64, 64).double()
    table = head.table
    out = torch.full((n, c), float("nan"))     # every logit written once
    scores = None
    for a0, q, e0, e1, e2, flags, win0, wins in head.steps.tolist():
        xs = x[:, a0 * 64:(a0 + 1) * 64]
        if flags & tproto.OPEN:
            scores = torch.zeros((n, 64))
        cross = sum(xs.double() @ split[q, pc].t()
                    for pc in reversed(range(pieces)))
        xn = (xs * xs).sum(-1, keepdim=True)
        d = torch.relu((xn - 2.0 * cross.float()) + head.chunk_pn[q])
        act = torch.log((d + 1.0) / (d + 1e-4))
        if g:
            for lo, hi in ((e0, e1), (e1, e2)):
                acc = torch.zeros((n, 4))
                for e in range(lo, hi):
                    meta = int(table[e, 4:5].view(torch.int32))
                    acc += act[:, meta & 63, None] * table[e, :4]
                    if meta & 64:
                        base = meta >> 8
                        scores[:, base:base + g] += acc[:, :g]
                        acc.zero_()
        else:
            kb = (wins + 1) // 2
            blk = table[e0]
            w = torch.cat([blk[:e1, 0, :kb], blk[:e1, 1, :wins - kb]], 1)
            scores[:, :wins] += act[:, :e1] @ w
        if flags & tproto.CLOSE:
            if g:
                o = torch.exp(scores[:, :wins]) @ \
                    head.glw_pad[win0:win0 + wins, :c]
                out = o if flags & tproto.WRITE else out + o
            else:
                out[:, win0:win0 + wins] = scores[:, :wins]
    return out.reshape(*feats.shape[:-1], c)
