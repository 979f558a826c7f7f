"""Weight carry between the JAX package's param trees and the port.

``ppnet_params_to_statedict`` turns a JAX ``params`` / ``batch_stats``
pair (nested dicts of numpy arrays) into a reference-named state dict with
OIHW kernels, re-packing the dense group weights per non-empty class as
the reference stores them; the port's ``PPNet`` loads the result with
``strict=True``.  It is the port's own copy of the JAX package's
``checkpoints/torch_convert.py`` exporter (the one behind
``convert_checkpoint export-torch``), so both produce the same dict for
the modules the port holds.

``quant_scales_from_jax`` / ``quant_scales_to_jax`` carry the calibrated
activation scales of a ``quant8='static'`` model between the JAX
package's ``quant_scales`` collection and the port's per-site buffers.

A checkpoint on disk is ``<stem>.pth`` (the state dict) beside
``<stem>.ckpt.json`` (the spec sidecar the JAX package writes next to
``<stem>.ckpt``).  ``load_checkpoint`` also reads a stem that exists only
as the JAX package's msgpack ``<stem>.ckpt`` (``checkpoints.jax_ckpt``),
carried here in memory; where both are present the ``.pth`` wins.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from scaleprotoseg_torch.spec import ProtoSpec

SIDECAR_FORMAT = "scaleprotoseg_tpu/v1"


def spec_from_meta(meta: Dict) -> ProtoSpec:
    """The ``spec`` entry of a checkpoint sidecar -> ProtoSpec."""
    return ProtoSpec.from_meta(meta)


def _convbn_to_statedict(tree: Dict, stats: Dict, out: Dict, prefix: str):
    """Walk ``{conv: {kernel, bias}, bn: {scale, bias}}`` nodes (with the
    ``batch_stats`` ``{bn: {mean, var}}`` beside them) and bare conv nodes
    ``{kernel[, bias]}`` (the U-Net's ``outc``) into reference-named torch
    keys (HWIO -> OIHW); other nodes are walked into.  An array this walk
    cannot place raises: nothing is dropped without a word."""
    for name, node in tree.items():
        if not isinstance(node, dict):
            raise ValueError(f"{prefix}{name}: an array outside a conv or "
                             "BN node cannot be carried")
        sub_stats = (stats or {}).get(name, {})
        if "conv" in node or "bn" in node:
            unknown = sorted(set(node) - {"conv", "bn"})
            if unknown:
                raise ValueError(f"{prefix}{name}: entries {unknown} beside "
                                 "conv / bn cannot be carried")
            conv = node.get("conv", {})
            _conv_to_statedict(conv, out, f"{prefix}{name}.conv.")
            bn = node.get("bn", {})
            sbn = sub_stats.get("bn", {})
            if bn:
                out[f"{prefix}{name}.bn.weight"] = np.asarray(bn["scale"])
                out[f"{prefix}{name}.bn.bias"] = np.asarray(bn["bias"])
                if "mean" in sbn:
                    out[f"{prefix}{name}.bn.running_mean"] = \
                        np.asarray(sbn["mean"])
                if "var" in sbn:
                    out[f"{prefix}{name}.bn.running_var"] = \
                        np.asarray(sbn["var"])
                out[f"{prefix}{name}.bn.num_batches_tracked"] = \
                    np.asarray(0, np.int64)
        elif "kernel" in node:
            _conv_to_statedict(node, out, f"{prefix}{name}.")
        else:
            _convbn_to_statedict(node, sub_stats, out, f"{prefix}{name}.")


def _conv_to_statedict(conv: Dict, out: Dict, prefix: str) -> None:
    """A flax conv's ``{kernel[, bias]}`` -> ``<prefix>weight`` (OIHW) and
    ``<prefix>bias``; any other entry raises."""
    unknown = sorted(set(conv) - {"kernel", "bias"})
    if unknown:
        raise ValueError(f"{prefix[:-1]}: conv entries {unknown} cannot be "
                         "carried")
    if "kernel" in conv:
        out[f"{prefix}weight"] = \
            np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in conv:
        out[f"{prefix}bias"] = np.asarray(conv["bias"])


def ppnet_params_to_statedict(params: Dict, batch_stats: Optional[Dict],
                              spec: ProtoSpec, log=print
                              ) -> Dict[str, np.ndarray]:
    """JAX param tree -> reference-named state dict (numpy values).

    Carries every subtree the port's ``PPNet`` holds: the backbone (its
    ConvBN nodes, bare convs, the ASPP branches and the 'concat_plus'
    ASPP's ``c{i}_pool`` Dense kernels (in, out) as Linears (out, in)),
    the add-on's ``conv{i}`` as ``add_on_layers.{2i}`` (the reference's
    Sequential puts an activation after each conv), the 'concat' scale
    head's ``linear`` as ``scale_head.output_layer.linear_block.0``, the
    prototypes and the plain or group head.  Any other subtree is named
    through ``log`` and not exported."""
    sd: Dict[str, np.ndarray] = {}
    bb = params.get("backbone", {})
    bstats = (batch_stats or {}).get("backbone", {})
    _convbn_to_statedict({k: v for k, v in bb.items() if k != "aspp"},
                         bstats, sd, "features.base.")
    for branch, entry in bb.get("aspp", {}).items():
        kernel = np.asarray(entry["kernel"])
        sd[f"features.base.aspp.{branch}.weight"] = \
            np.ascontiguousarray(kernel.T) if kernel.ndim == 2 else \
            kernel.transpose(3, 2, 0, 1)
        if "bias" in entry:
            sd[f"features.base.aspp.{branch}.bias"] = \
                np.asarray(entry["bias"])

    if "prototype_vectors" in params:
        pv = np.asarray(params["prototype_vectors"])
        sd["prototype_vectors"] = pv.reshape(pv.shape[0], pv.shape[1], 1, 1)
    if "last_layer" in params:
        sd["last_layer.weight"] = \
            np.ascontiguousarray(np.asarray(params["last_layer"]).T)
    nonzero = spec.nonempty_classes if (
        "last_layer_group" in params or "group_projection" in params) else ()
    if "last_layer_group" in params:
        g = spec.num_groups
        full = np.asarray(params["last_layer_group"])   # (C*G, C)
        w = np.zeros((spec.num_classes, len(nonzero) * g), np.float32)
        for k, c in enumerate(nonzero):
            w[:, k * g:(k + 1) * g] = full[c * g:(c + 1) * g, :].T
        sd["last_layer_group.weight"] = w
    if "group_projection" in params:
        gw = np.asarray(params["group_projection"])     # (C, G, Pc_max)
        for k, c in enumerate(nonzero):
            pc = spec.class_counts[c]
            sd[f"group_projection.{k}.weight"] = \
                np.ascontiguousarray(gw[c, :, :pc], np.float32)
    if "scale_head" in params:
        lin = params["scale_head"]["linear"]
        prefix = "scale_head.output_layer.linear_block.0."
        sd[prefix + "weight"] = np.ascontiguousarray(
            np.asarray(lin["kernel"]).T)
        if "bias" in lin:
            sd[prefix + "bias"] = np.asarray(lin["bias"])
    addon = params.get("add_on_layers", {})
    for name in sorted(addon, key=lambda n: int(n[len("conv"):])):
        _conv_to_statedict(addon[name], sd,
                           f"add_on_layers.{2 * int(name[len('conv'):])}.")
    handled = {"backbone", "prototype_vectors", "last_layer",
               "last_layer_group", "group_projection", "scale_head",
               "add_on_layers"}
    dropped = sorted(k for k in params if k not in handled)
    if dropped:
        log(f"export-torch: NOT exporting unrecognized param subtree(s) "
            f"{dropped}")
    return sd


def bootstrap_group_state(group_state: Dict[str, torch.Tensor],
                          proto_state: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A grouped model's state dict started from a prototype-phase
    checkpoint's: the backbone (``features.*``) and the prototypes come
    from ``proto_state``, the group heads stay as ``group_state`` holds
    them (freshly initialized).  Every other key of ``proto_state`` must
    be one the group model does not have (the plain last layer)."""
    out = dict(group_state)
    for key, value in proto_state.items():
        if key.startswith("features.") or key == "prototype_vectors":
            if key not in out or out[key].shape != value.shape:
                raise ValueError(
                    f"{key}: {tuple(value.shape)} in the checkpoint, "
                    f"{tuple(out[key].shape) if key in out else 'absent'} "
                    "in the group model")
            out[key] = value
        elif key in out:
            raise ValueError(f"{key}: a prototype-phase key the group model "
                             "also holds would be dropped")
    return out


def quant_scales_from_jax(tree: Dict) -> Dict[str, np.float32]:
    """The JAX package's ``quant_scales`` collection (nested dicts keyed by
    each ``_QuantConv`` site's path, ``backbone/layer4/block1/reduce/conv/
    x_scale``) -> ``{port module name: float32 scale}``, the module names
    of the port's ``QuantConvBN`` sites (``features.base.layer4.block1.
    reduce``), for ``model_loading.set_quant_scales``."""
    out: Dict[str, np.float32] = {}

    def walk(node, path):
        if not isinstance(node, dict):
            if path[-2:] != ["conv", "x_scale"] or path[0] != "backbone":
                raise ValueError(f"not a quant_scales leaf: {'/'.join(path)}")
            name = ".".join(["features.base", *path[1:-2]])
            out[name] = np.float32(np.asarray(node))
            return
        for key, child in node.items():
            walk(child, path + [str(key)])

    walk(tree, [])
    return out


def quant_scales_to_jax(scales: Dict[str, float]) -> Dict:
    """Inverse of ``quant_scales_from_jax``."""
    tree: Dict = {}
    prefix = "features.base."
    for name, value in scales.items():
        if not name.startswith(prefix):
            raise ValueError(f"not a backbone quant8 site: {name}")
        node = tree.setdefault("backbone", {})
        for part in name[len(prefix):].split("."):
            node = node.setdefault(part, {})
        node["conv"] = {"x_scale": np.float32(value)}
    return tree


def to_tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy state dict -> tensors (copies, so read-only arrays are fine);
    tensors (bf16 ones among them) pass as they are."""
    return {k: v if isinstance(v, torch.Tensor) else
            torch.tensor(np.asarray(v)) for k, v in sd.items()}


def synthetic_state_dict(model: nn.Module, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Random nonzero weights for every entry of ``model.state_dict()``,
    drawn from ``numpy.random.default_rng(seed)``: He-scaled kernels,
    BN weight ~= 1, biases and means 0, running variance 1, prototypes
    U[0, 1), group-projection rows on the simplex.  The port's counterpart
    of the JAX package's ``synthetic_init``: activations stay finite at
    full ResNet-101 depth."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if key.endswith("num_batches_tracked"):
            out[key] = np.zeros(shape, np.int64)
        elif key.endswith("running_var"):
            out[key] = np.ones(shape, np.float32)
        elif key.endswith("running_mean") or key.endswith(".bias"):
            out[key] = np.zeros(shape, np.float32)
        elif key.endswith("bn.weight"):
            out[key] = (1.0 + 0.01 * rng.standard_normal(shape)) \
                .astype(np.float32)
        elif key.startswith("group_projection."):
            w = rng.random(shape) + 1e-3
            out[key] = (w / w.sum(-1, keepdims=True)).astype(np.float32)
        elif key == "prototype_vectors":
            out[key] = rng.random(shape).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            out[key] = (np.sqrt(2.0 / fan_in)
                        * rng.standard_normal(shape)).astype(np.float32)
    return out


def save_checkpoint(stem: str, state_dict: Dict[str, np.ndarray],
                    spec: Optional[ProtoSpec],
                    extra: Optional[Dict] = None) -> None:
    """Write ``<stem>.pth`` and the ``<stem>.ckpt.json`` spec sidecar
    (without a ``spec`` entry when ``spec`` is None)."""
    os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)
    torch.save(to_tensors(state_dict), stem + ".pth")
    meta = {"format": SIDECAR_FORMAT}
    if spec is not None:
        meta["spec"] = spec.to_meta()
    if extra:
        meta["extra"] = extra
    with open(stem + ".ckpt.json", "w") as f:
        json.dump(meta, f, indent=2)


def load_jax_checkpoint(path: str, log=print):
    """(state dict of tensors, sidecar metadata) of the JAX package's
    msgpack ``.ckpt`` at ``path``, carried by
    ``ppnet_params_to_statedict`` (a checkpoint without a spec, the
    backbone alone, carries no head)."""
    from scaleprotoseg_torch.checkpoints import jax_ckpt
    params, batch_stats, meta = jax_ckpt.load_checkpoint(path)
    spec = spec_from_meta(meta["spec"]) if "spec" in meta else None
    return to_tensors(ppnet_params_to_statedict(params, batch_stats, spec,
                                                log=log)), meta


def load_checkpoint(stem: str):
    """(state dict of tensors, sidecar metadata) for ``<stem>``: its
    ``.pth`` and ``.ckpt.json``, or where no ``.pth`` exists, the JAX
    package's ``<stem>.ckpt`` (``load_jax_checkpoint``)."""
    if not os.path.exists(stem + ".pth") and os.path.exists(stem + ".ckpt"):
        return load_jax_checkpoint(stem + ".ckpt")
    sd = torch.load(stem + ".pth", map_location="cpu", weights_only=True)
    with open(stem + ".ckpt.json") as f:
        meta = json.load(f)
    return sd, meta


def _array_leaves(tree, path=()):
    """(path, array) of the numpy leaves of nested dicts; other leaves
    (the optax state's placeholders for another label's parameters) are
    skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _array_leaves(v, path + (k,))
    elif isinstance(tree, (np.ndarray, np.generic)):
        yield path, np.asarray(tree)


def _merge(trees) -> Dict:
    """One nested dict holding the array leaves of ``trees``."""
    out: Dict = {}
    for tree in trees:
        for path, leaf in _array_leaves(tree):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
    return out


def train_state_from_jax(params: Dict, batch_stats: Optional[Dict],
                         opt_state, step: int, spec: ProtoSpec,
                         names) -> Dict:
    """The JAX package's train state as the port's
    (``TrainState.load_state_dict``'s input), for the phase optimizer
    whose trainable parameters are ``names`` (``PhaseOptimizer.names``).

    Takes numpy trees: ``params`` and ``batch_stats``, and the optax
    state of the JAX package's phase optimizer (``train/optim.py``
    ``make_phase_optimizer``), ``apply_if_finite`` around ``MultiSteps``
    (when ``iter_size`` > 1) around ``multi_transform`` of one
    ``add_decayed_weights`` -> ``scale_by_adam`` -> ... chain per label,
    with its named tuples kept (``jax.tree.map(np.asarray, ...)`` keeps
    them).  Read from it: the non-finite streak, ``MultiSteps``'
    micro-step counter and gradient running mean ``acc_grads``, each
    label's Adam ``count``, ``mu`` and ``nu``; the updates done (the
    schedule's count) is the Adam count."""
    model = ppnet_params_to_statedict(params, batch_stats, spec,
                                      log=lambda _: None)
    streak = getattr(opt_state, "notfinite_count", 0)
    inner = getattr(opt_state, "inner_state", opt_state)
    if hasattr(inner, "mini_step"):
        mini, acc_tree = inner.mini_step, inner.acc_grads
        inner = inner.inner_opt_state
    else:
        mini, acc_tree = 0, None
    adams = {}
    for label, masked in inner.inner_states.items():
        chain = getattr(masked, "inner_state", masked)
        adams[label] = next(s for s in chain if hasattr(s, "mu"))
    counts = {int(a.count) for a in adams.values()}
    if len(counts) != 1:
        raise ValueError(f"the labels' Adam counts differ: {counts}")
    count = counts.pop()
    convert = lambda tree: ppnet_params_to_statedict(  # noqa: E731
        tree, None, spec, log=lambda _: None)
    mu = convert(_merge(a.mu for a in adams.values()))
    nu = convert(_merge(a.nu for a in adams.values()))
    if set(mu) != set(names):
        raise ValueError("the JAX optimizer state covers other parameters: "
                         f"{sorted(set(mu) ^ set(names))[:8]}")
    acc = convert(_merge([acc_tree])) if acc_tree is not None else None
    flat = np.concatenate([
        (acc[n] if acc is not None else np.zeros_like(mu[n]))
        .astype(np.float32).reshape(-1) for n in names])
    tensor = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    return {"step": int(step), "model": to_tensors(model),
            "optimizer": {
                "names": list(names),
                "exp_avg": [tensor(mu[n]) for n in names],
                "exp_avg_sq": [tensor(nu[n]) for n in names],
                "step": [torch.tensor(float(count)) for _ in names],
                "acc": torch.tensor(flat),
                "mini": torch.tensor(int(mini), dtype=torch.int64),
                "streak": torch.tensor(int(streak), dtype=torch.int64),
                "updates": torch.tensor(float(count))},
            "extra": {}}
