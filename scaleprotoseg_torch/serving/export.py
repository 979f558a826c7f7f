"""The inference forward of the serving path, and its deployable artifact.

``make_serving_fn`` returns ``fn(x) -> labels``: optional on-device
normalization of raw uint8 RGB, the model (fused prototype head when
``fast``), then the label upsample + argmax (the fused K3 kernel when
``fast``).

A dynamic quant8 model (``quant8=True``) serves without ``fast``, as in
the JAX package; a static one serves with it once calibrated, and an
uncalibrated static model raises at its first quantized conv.

The artifact is the counterpart of the JAX package's ``jax.export`` one:
``export_serving`` traces the same forward with ``torch.export`` into an
``ExportedProgram`` whose kernels are the registered ``scaleprotoseg::``
ops (K1, K2, K3 and the int8 kernels, one node each, the card's kernel or
the plain version by the device of their inputs); ``save_artifact`` writes
it and ``load_artifact`` serves it without the model code or the gin
stack.  Artifact layout (a directory)::

    module.pt2          torch.export.save of the program, its state
                        replaced by stride-0 placeholders of the same
                        shapes (the weights live once, below)
    weights.pth         the program's state: parameters, buffers (the
                        packed kernel forms among them) and tensor
                        constants (a static quant8 model's calibrated
                        ``x_scale``s among them), in the checkpoint format
                        of ``checkpoints/convert.py``
    weights.ckpt.json   its sidecar (format, spec, extra)
    meta.json           input spec, output spec, platforms, extra

``load_artifact`` loads ``weights.pth`` into the program's state, so a
weights file of the same shapes (other pushed or pruned weights) re-points
the artifact.  ``torch.export.load`` resolves the ops only where
``scaleprotoseg_torch.kernels`` is importable: ``load_artifact`` imports
it, and the checkpoint reader, and nothing of the models.

Batch handling: ``batch=None`` exports with a symbolic batch dimension
(``torch.export.Dim``) and turns the model's fast ASPP off, as the JAX
package does; a fixed ``batch`` also allows the fused kernel path
(``fast=True``).  A model with the MSC input pyramid exports whole: the
backbone once per map, the pyramid's resize matrices as constants of the
program, and the max fusion.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from scaleprotoseg_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from scaleprotoseg_torch.kernels.upsample import (fused_upsample_argmax,
                                                  label_dtype)
from scaleprotoseg_torch.ops.resize import resize_bilinear_matrix

_FORMAT = "scaleprotoseg_torch/serving/v1"
PLATFORMS = ("cpu", "cuda")
MAX_BATCH = 4096          # the symbolic batch dimension's upper bound


class ServingForward(nn.Module):
    """The serving forward of ``model`` as a module (what export traces);
    see ``make_serving_fn`` for the arguments."""

    def __init__(self, model, *, output: str = "labels",
                 upsample: bool = True, fast: bool = False,
                 normalize_to: Optional[torch.dtype] = None):
        super().__init__()
        if output not in ("labels", "logits"):
            raise ValueError(f"output must be labels|logits, got {output!r}")
        if getattr(model.features.base, "quant8", False) is True:
            fast = False
        self.model = model
        self.output, self.upsample, self.fast = output, upsample, fast
        self.normalize_to = normalize_to
        device = next(model.parameters()).device
        kw = dict(dtype=torch.float32, device=device)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN, **kw),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD, **kw),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        height, width = x.shape[1], x.shape[2]
        if self.normalize_to is not None:
            x = ((x.float() / 255.0 - self.mean) / self.std).to(
                self.normalize_to)
        model = self.model
        logits = model.fast_logits(x) if self.fast else model(x).logits
        if self.output == "labels":
            if self.upsample and self.fast:
                return fused_upsample_argmax(logits, height, width)
            if self.upsample:
                logits = resize_bilinear_matrix(logits, height, width)
            return logits.argmax(dim=-1).to(label_dtype(logits.shape[-1]))
        if self.upsample:
            logits = resize_bilinear_matrix(logits, height, width)
        return logits


def make_serving_fn(model, *, output: str = "labels", upsample: bool = True,
                    fast: bool = False,
                    normalize_to: Optional[torch.dtype] = None):
    """``fn(x)`` for a batch ``x`` (B, H, W, 3) on the model's device.

    ``output='labels'`` returns (B, H, W) uint8 train ids (int32 above 255
    classes); ``'logits'`` the float32 (B, h, w, C) map, upsampled to the
    input size when ``upsample``.  ``normalize_to`` makes ``fn`` take raw
    uint8 and compute ``(x / 255 - mean) / std`` in float32 on the device,
    the same float32 ops as the host pipeline, then cast to this dtype."""
    forward = ServingForward(model, output=output, upsample=upsample,
                             fast=fast, normalize_to=normalize_to)

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        return forward(x)

    return fn


def export_serving(model, *, height: int, width: int,
                   batch: Optional[int] = None,
                   input_dtype: torch.dtype = torch.bfloat16,
                   output: str = "labels", upsample: bool = True,
                   fast: bool = False,
                   platforms: Optional[Sequence[str]] = None,
                   device_preprocess: bool = False
                   ) -> torch.export.ExportedProgram:
    """Trace the serving forward of ``model`` (on its device) into an
    ``ExportedProgram``; its ``platforms`` attribute names the devices it
    serves on.

    ``platforms``: a subset of ``("cpu", "cuda")``, default the model's
    device; more than one means the plain path (no kernel op), as the
    JAX package drops Pallas for a multi-platform export.  ``batch=None``
    uses a symbolic batch dimension (incompatible with ``fast=True``).
    ``device_preprocess=True`` bakes the float32 normalization into the
    program: it then takes raw uint8 RGB (``input_dtype`` names the
    model's dtype after normalization)."""
    if fast and batch is None:
        raise ValueError("fast=True needs a fixed batch: the fused kernel "
                         "path is exported at one batch shape")
    device = next(model.parameters()).device
    platforms = tuple(platforms) if platforms else (device.type,)
    if not set(platforms) <= set(PLATFORMS):
        raise ValueError(f"platforms must be among {PLATFORMS}, got "
                         f"{platforms}")
    aspp = model.aspp
    fast_aspp = aspp is not None and aspp.fast
    if len(platforms) > 1:
        fast = False
    if aspp is not None and (batch is None or len(platforms) > 1):
        aspp.fast = False
    forward = ServingForward(
        model, output=output, upsample=upsample, fast=fast,
        normalize_to=input_dtype if device_preprocess else None)
    wire = torch.uint8 if device_preprocess else input_dtype
    x = torch.zeros((batch or 2, height, width, 3), dtype=wire, device=device)
    dims = None if batch else (
        {0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},)
    from scaleprotoseg_torch.models.layers import packed_as_buffers
    # the model's own packed form is K1's head, read by fast_logits alone
    held = [m for m in model.modules() if forward.fast or m is not model]
    try:
        with torch.no_grad(), packed_as_buffers(held):
            exported = torch.export.export(forward, (x,),
                                           dynamic_shapes=dims, strict=False)
    finally:
        if aspp is not None:
            aspp.fast = fast_aspp
    exported.platforms = platforms
    return exported


def _program_state(exported: torch.export.ExportedProgram
                  ) -> Dict[str, torch.Tensor]:
    """The program's weights by name: its state dict and its tensor
    constants (non-persistent buffers, lifted constants)."""
    state = dict(exported.state_dict)
    state.update((k, v) for k, v in exported.constants.items()
                 if isinstance(v, torch.Tensor))
    return state


def save_artifact(path: str, exported: torch.export.ExportedProgram,
                  spec=None, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the serving artifact directory (see the module docstring)."""
    from scaleprotoseg_torch.checkpoints.convert import save_checkpoint

    os.makedirs(path, exist_ok=True)
    state = _program_state(exported)
    save_checkpoint(os.path.join(path, "weights"),
                    {k: v.detach().cpu() for k, v in state.items()},
                    spec=spec, extra=extra)
    # the program file keeps each weight's shape and dtype, not its values,
    # and no example input
    stores = (exported.state_dict, exported.constants)
    saved = [(d, k, d[k]) for d in stores for k in list(d) if k in state]
    example = exported.example_inputs
    try:
        for d, k, v in saved:
            d[k] = _placeholder(v)
        exported.example_inputs = None
        tmp = os.path.join(path, "partial-module.pt2")
        with warnings.catch_warnings():
            # a placeholder covers one element, not its whole shape
            warnings.filterwarnings("ignore", "No complete tensor found")
            torch.export.save(exported, tmp)
        os.replace(tmp, os.path.join(path, "module.pt2"))
    finally:
        for d, k, v in saved:
            d[k] = v
        exported.example_inputs = example
    sig = exported.graph_signature
    x_name = sig.user_inputs[0]
    out_name = sig.user_outputs[0]
    nodes = {n.name: n for n in exported.graph.nodes}
    x_val, out_val = nodes[x_name].meta["val"], nodes[out_name].meta["val"]
    meta = {
        "format": _FORMAT,
        "input": {
            "shape": [_dim(d) for d in x_val.shape],
            "dtype": str(x_val.dtype).removeprefix("torch."),
            # uint8 input <=> the normalization is part of the program
            "device_normalize": x_val.dtype == torch.uint8,
        },
        "output": {
            "shape": [_dim(d) for d in out_val.shape],
            "dtype": str(out_val.dtype).removeprefix("torch."),
        },
        "platforms": list(getattr(exported, "platforms", ())),
        "extra": extra or {},
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def _placeholder(t: torch.Tensor) -> torch.Tensor:
    """A host tensor of ``t``'s shape and dtype over one element (the
    archive writer copies a card tensor to the host in full first)."""
    p = torch.zeros((), dtype=t.dtype).expand(t.shape)
    return nn.Parameter(p, requires_grad=False) \
        if isinstance(t, nn.Parameter) else p


def _dim(d) -> Optional[int]:
    return int(d) if isinstance(d, int) else None


@functools.lru_cache(maxsize=None)
def _roomy_call():
    """``call(fn, x)``: ``fn(x)`` run below a frame that opens a fresh
    256 KiB chunk of CPython's frame stack, half of it left free.

    The program's forward is one Python function with a local for every
    node and weight (about 2000 for the static quant8 flagship).  CPython
    (3.11 on) keeps frames in chunks of at least 16 KiB and frees a chunk
    as soon as the frame at its base returns, so a frame that nearly fills
    its chunk makes every Python call made from it (the kernel ops are
    implemented in Python) map and unmap a chunk of its own.  Where the
    forward's frame lands depends on its caller's depth; on the H100 the
    static quant8 artifact served at a quarter of the run-dir serve's
    rate when it landed badly (``chip_smoke.py``'s artifact phase).  This
    frame declares 16384 locals it never binds: no chunk in use holds it,
    CPython opens a 32768-slot chunk for it, and the forward and every
    call below it fit in the half that is left."""
    n = 1 << 14
    src = ("def call(fn, x):\n    if fn is None:\n        "
           + " = ".join(f"_{i}" for i in range(n))
           + " = None\n    return fn(x)\n")
    scope: Dict[str, Any] = {}
    exec(compile(src, "<serving frame room>", "exec"), scope)
    return scope["call"]


@dataclasses.dataclass
class ServingModel:
    """A loaded artifact: ``predict(x)`` runs the program."""

    call: Any               # the program's module
    meta: Dict[str, Any]
    device: torch.device
    spec: Any = None

    @property
    def input_shape(self) -> Tuple[Optional[int], ...]:
        return tuple(self.meta["input"]["shape"])

    @property
    def input_dtype(self) -> torch.dtype:
        return getattr(torch, self.meta["input"]["dtype"])

    def predict(self, x) -> torch.Tensor:
        """The program's output on the artifact's device (asynchronous on
        the card)."""
        x = torch.as_tensor(x).to(self.device, self.input_dtype)
        fixed = self.input_shape[1:]
        if tuple(x.shape[1:]) != fixed:
            raise ValueError(f"input {tuple(x.shape[1:])} != exported "
                             f"{fixed}")
        b = self.input_shape[0]
        if b is not None and x.shape[0] != b:
            raise ValueError(f"batch {x.shape[0]} != exported {b} "
                             "(artifact was exported with a fixed batch)")
        with torch.inference_mode():
            return _roomy_call()(self.call, x)


def load_artifact(path: str, device=None) -> ServingModel:
    """Load ``module.pt2`` and ``weights.pth`` on ``device`` (``cuda``
    unless the caller names another; an error without a card); no model
    code is imported."""
    # the ops the program calls
    import scaleprotoseg_torch.kernels  # noqa: F401
    from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                         spec_from_meta)
    from scaleprotoseg_torch.device import resolve_device

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT:
        raise ValueError(f"not a serving artifact: {meta.get('format')!r}")
    dev = resolve_device(device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"the artifact serves on {meta['platforms']}, not "
                         f"{dev.type}")
    exported = torch.export.load(os.path.join(path, "module.pt2"))
    state, wmeta = load_checkpoint(os.path.join(path, "weights"))
    stores = (exported.state_dict, exported.constants)
    names = {k for d in stores for k, v in d.items()
             if isinstance(v, torch.Tensor)}
    if names != set(state):
        raise ValueError(f"weights.pth does not match the program: missing "
                         f"{sorted(names - set(state))}, unknown "
                         f"{sorted(set(state) - names)}")
    for d in stores:
        for k in names & set(d):
            v = state[k]
            if v.shape != d[k].shape or v.dtype != d[k].dtype:
                raise ValueError(f"weights.pth: {k} is {v.dtype} "
                                 f"{tuple(v.shape)}, the program takes "
                                 f"{d[k].dtype} {tuple(d[k].shape)}")
            d[k] = nn.Parameter(v, requires_grad=False) \
                if isinstance(d[k], nn.Parameter) else v
    from torch.export.passes import move_to_device_pass
    exported = move_to_device_pass(exported, dev)
    spec = spec_from_meta(wmeta["spec"]) if "spec" in wmeta else None
    return ServingModel(call=exported.module(), meta=meta, device=dev,
                        spec=spec)


def export_from_run(model_path: str, checkpoint_path: str, out_dir: str, *,
                    height: int, width: int, batch: Optional[int] = None,
                    output: str = "labels", fast: bool = False,
                    quant8=False, calibration=None,
                    input_dtype: torch.dtype = torch.bfloat16,
                    platforms: Optional[Sequence[str]] = None,
                    device=None) -> str:
    """Run-dir checkpoint -> serving artifact (the deploy one-liner).

    ``quant8='static'`` needs ``calibration``: an iterable of normalized
    (B, H, W, 3) input batches on the model's device in ``input_dtype``
    (``model_loading.calibrate_quant_scales``); the scales ship inside
    the artifact."""
    from scaleprotoseg_torch.model_loading import (calibrate_quant_scales,
                                                   load_model)

    model, spec = load_model(model_path, checkpoint_path, dtype=input_dtype,
                             fast=fast, device=device, quant8=quant8)
    if quant8 == "static":
        if calibration is None:
            raise ValueError("quant8='static' export needs calibration "
                             "batches")
        calibrate_quant_scales(model, calibration)
    exported = export_serving(model, height=height, width=width, batch=batch,
                              output=output, input_dtype=input_dtype,
                              fast=fast, platforms=platforms)
    save_artifact(out_dir, exported, spec=spec,
                  extra={"model_path": model_path,
                         "checkpoint": checkpoint_path, "fast": fast,
                         "quant8": quant8})
    return out_dir
