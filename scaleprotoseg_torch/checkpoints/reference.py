"""The reference's whole-module pickles (``torch.save(ppnet)``), read
without running code from them.

The released ScaleProtoSeg checkpoints (``push_final.pth``,
``final-group.pth``) pickle whole ``nn.Module`` trees whose classes live
in the reference's ``segmentation.*`` and ``deeplab_pytorch.*`` packages,
which are not installed.  ``load_reference_pickle`` unpickles them with
``RestrictedUnpickler``:

- the globals a tensor needs are the real ones: torch's
  ``_utils._rebuild_tensor_v2`` and ``_utils._rebuild_parameter``, the
  storage types (torch's own loader resolves them), and the containers
  of a module's state, ``collections.OrderedDict`` and ``builtins.set``
  (``nn.Module._non_persistent_buffers_set``);
- every other global, the reference's classes and torch's ``nn`` classes
  alike, becomes an inert stub class: the pickle's ``NEWOBJ`` makes an
  empty instance of it and ``BUILD`` fills its ``__dict__``, so the
  module tree's ``_parameters`` / ``_buffers`` / ``_modules`` dicts are
  there to walk, and no method of any class runs;
- calling any other global (the pickle's ``REDUCE``: ``os.system``,
  ``builtins.eval``, a stub class) raises ``pickle.UnpicklingError``
  with its name, before the call.

Nothing is imported by name from the pickle, so a module a pickle names
is never loaded either.

``reference_metadata`` reads the non-tensor attributes the reference keeps
on the module (``num_scales``, ``scale_num_prototypes``, ``num_groups``,
``prototype_class_identity``, ...) and ``spec_from_reference_meta``
rebuilds the bank's ``ProtoSpec`` from them, so a pushed or pruned bank
keeps its irregular scale ranges.  The port's copy of the JAX package's
``checkpoints/torch_convert.py`` reference path.
"""

from __future__ import annotations

import collections
import io
import pickle
import types
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from scaleprotoseg_torch.spec import ProtoSpec

# attributes of the reference's module object that a state dict lacks
META_KEYS = ("num_scales", "scale_num_prototypes", "num_groups", "epsilon",
             "incorrect_strength", "img_size",
             "prototype_activation_function", "patch_classification")
# state-dict prefixes the port's PPNet holds (the reference's own names)
MODEL_PREFIXES = ("features.base.", "prototype_vectors", "last_layer.",
                  "last_layer_group.", "group_projection.",
                  "add_on_layers.", "scale_head.")


_PY2_NAMES = {"__builtin__": "builtins"}


def _allowed() -> Dict[Tuple[str, str], object]:
    from torch import _utils
    return {("torch._utils", "_rebuild_tensor_v2"): _utils._rebuild_tensor_v2,
            ("torch._utils", "_rebuild_parameter"): _utils._rebuild_parameter,
            ("collections", "OrderedDict"): collections.OrderedDict,
            ("builtins", "set"): set}


class _Inert(type):
    """Metaclass of the stubs: calling a stub (``REDUCE``) raises."""

    def __call__(cls, *args, **kwargs):
        raise pickle.UnpicklingError(
            f"reference pickle: a call of {cls.__module__}.{cls.__name__} "
            "refused (the port runs no code from a weights file)")


class Stub(metaclass=_Inert):
    """An instance of a class the pickle names: its ``__dict__`` is the
    pickled state and nothing else."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:
            state = {**(state[0] or {}), **(state[1] or {})}
        if isinstance(state, dict):
            self.__dict__.update(state)


class RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        module = _PY2_NAMES.get(module, module)   # protocol 2's names
        real = _allowed().get((module, name))
        if real is not None:
            return real
        return _Inert(name, (Stub,), {"__module__": module})


def _pickle_module() -> types.ModuleType:
    mod = types.ModuleType("restricted_pickle")
    mod.Unpickler = RestrictedUnpickler
    mod.load = lambda f, **kw: RestrictedUnpickler(f, **kw).load()
    mod.loads = lambda b, **kw: RestrictedUnpickler(io.BytesIO(b),
                                                    **kw).load()
    return mod


def walk_tensors(mod, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(name, tensor) of the parameters and buffers of a module tree of
    stubs, as ``named_parameters`` + ``named_buffers`` would name them:
    the ``_parameters`` / ``_buffers`` / ``_modules`` dicts walked
    directly."""
    d = getattr(mod, "__dict__", {})
    for coll in ("_parameters", "_buffers"):
        for name, t in (d.get(coll) or {}).items():
            if t is not None:
                yield prefix + name, t
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            yield from walk_tensors(child, prefix + name + ".")


def reference_metadata(obj) -> Dict:
    """The reference module's attributes of ``META_KEYS`` and its
    ``prototype_class_identity`` (as numpy)."""
    d = getattr(obj, "__dict__", {})
    meta = {k: d[k] for k in META_KEYS if k in d}
    pci = d.get("prototype_class_identity")
    if isinstance(pci, torch.Tensor):
        meta["prototype_class_identity"] = pci.detach().cpu().numpy()
    return meta


def load_reference_pickle(path: str) -> Tuple[Dict[str, torch.Tensor],
                                              Dict]:
    """(state dict of every tensor in the pickled module tree, metadata)
    of a reference whole-module pickle."""
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_pickle_module())
    sd = {k: v.detach() for k, v in walk_tensors(obj)
          if isinstance(v, torch.Tensor)}
    if not sd:
        raise ValueError(f"{path}: no tensors in {type(obj).__name__}")
    return sd, reference_metadata(obj)


def model_state_dict(sd: Mapping[str, torch.Tensor], log=print
                     ) -> Dict[str, torch.Tensor]:
    """The tensors of ``sd`` the port's ``PPNet`` holds (``MODEL_PREFIXES``,
    names unchanged: the port keeps the reference's); the others (the
    reference's constant ``ones``) are named through ``log``."""
    keep = {k: v for k, v in sd.items()
            if k.startswith(MODEL_PREFIXES) or k == "prototype_vectors"}
    dropped = sorted(set(sd) - set(keep))
    if dropped:
        log(f"reference pickle: not part of the model, left out: {dropped}")
    return keep


def spec_from_reference_meta(sd: Mapping[str, torch.Tensor], meta: Dict
                             ) -> ProtoSpec:
    """The bank's ``ProtoSpec`` from the pickle's tensors and metadata:
    the scale ranges from ``scale_num_prototypes`` (irregular after push
    or pruning), the classes from ``prototype_class_identity`` (a row
    without a class: -1); without the identity, the equal allocation of
    the bank over the last layer's classes."""
    pv = sd["prototype_vectors"]
    num_prototypes = int(pv.shape[0])
    depth = int(np.prod(tuple(pv.shape[1:])))
    num_scales = int(meta.get("num_scales", 1))
    num_groups = int(meta.get("num_groups", 0) or 0)
    pci = meta.get("prototype_class_identity")
    if pci is None:
        last = sd.get("last_layer.weight", sd.get("last_layer_group.weight"))
        return ProtoSpec.equal_allocation(
            num_prototypes, depth, int(last.shape[0]), num_scales,
            num_groups=num_groups)
    snp = meta.get("scale_num_prototypes")
    if snp:
        bounds = tuple(tuple(int(v) for v in snp[s]) for s in sorted(snp))
    else:
        per = num_prototypes // num_scales
        bounds = tuple((s * per, (s + 1) * per) for s in range(num_scales))
    pci = np.asarray(pci)
    class_ids = tuple(int(np.argmax(row)) if row.any() else -1
                      for row in pci)
    return ProtoSpec(num_classes=int(pci.shape[1]), num_scales=num_scales,
                     proto_depth=depth, class_ids=class_ids,
                     scale_bounds=bounds, num_groups=num_groups)
