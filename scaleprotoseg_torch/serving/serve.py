"""Serving CLI: stream a directory of images through the model and write
label maps.  Two model sources:

    python -m scaleprotoseg_torch.serving.serve MODEL_NAME PHASE \\
        --input DIR [--output DIR] [--batch N] [--device cuda|cpu]

rebuilds the model from ``<results-root>/MODEL_NAME`` (``config.gin``
plus the ``checkpoints/<stage>.pth`` state dict and its ``.ckpt.json``
spec);

    python -m scaleprotoseg_torch.serving.serve --artifact DIR --input DIR

serves a serving artifact (``serving/export.py``: a ``torch.export``
program and its weights) and imports no model code and no gin; the
artifact dictates the batch (unless exported with ``--dynamic-batch``)
and the preprocess split.  ``--export DIR`` added to the first form
writes the artifact of that model instead of serving (the deploy step),
at the first image's size and ``--batch`` (``--dynamic-batch``: a
symbolic batch; ``--platforms cpu,cuda``: a program for both devices;
both take the plain path).

Input: ``.npy`` uint8 images (or ``.png``/``.jpg``) of one shape, less
``--margin`` pixels on each side; ``--canvas H W`` serves a mixed-size
directory by bottom/right-padding each image to H x W and cropping each
prediction back (an image larger than the canvas is refused).  Output:
one grayscale PNG of train ids per image (``--raw-output``: ``.npy``
arrays) and a JSON throughput line.

The device is ``cuda`` unless ``--device`` names another; without a card
that is an error, not a silent CPU run.  On the card the fast path runs
(bf16 backbone, the K2 ASPP, K1 prototype-head and K3 upsample-argmax
kernels; ``--no-fast`` turns it off); on the CPU the float32 plain path.
Normalization runs on the device by default: raw uint8 ships to the card
and the forward computes ``(x / 255 - mean) / std`` in float32
(``--host-preprocess`` normalizes on the host instead; ``--canvas``, whose
pad is the dataset mean, and float sources imply it).

``--quant8-static`` runs layer4/5 as int8 convs with activation scales
calibrated on the first ``--calib-images`` inputs (host-normalized, one
image per batch) and keeps the fast path: on the card the int8 kernels
run beside K1, K2 and K3.  ``--quant8`` is the dynamic form, which
serves without the fast path, as in the JAX package.  The record line
says which (``"quant8"``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from scaleprotoseg_torch import settings
from scaleprotoseg_torch.constants import IMAGENET_MEAN, IMAGENET_STD


def _list_images(input_dir: str, limit: Optional[int]) -> List[str]:
    names = sorted(p for p in os.listdir(input_dir)
                   if p.endswith((".npy", ".png", ".jpg")))
    if not names:
        raise FileNotFoundError(f"no .npy/.png/.jpg images in {input_dir}")
    return names[:limit] if limit else names


def _load(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _make_preprocess(input_dir: str, margin: int = 0, canvas=None,
                     sizes=None, normalize: bool = True):
    """Decode, crop ``margin`` pixels off each side, then normalize to
    float32 (``normalize``) or pass raw uint8 through for on-device
    normalization.  With ``canvas=(H, W)`` every image is bottom/right-
    padded to that shape (zeros after normalization: the dataset mean),
    so one program serves a mixed-size directory; ``sizes`` (a dict)
    records each name's size before the pad, for the crop back, and is
    filled in the preprocess threads before that item's batch is
    dispatched.  An image larger than the canvas raises."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)

    def preprocess(name: str) -> np.ndarray:
        img = _load(os.path.join(input_dir, name))
        if margin:
            img = img[margin:-margin, margin:-margin]
        if canvas is not None and not normalize:
            # the pad must be the dataset mean exactly, which uint8 cannot
            # hold, so main() takes the host path under --canvas
            raise ValueError("--canvas needs host preprocessing")
        if normalize:
            out = (img.astype(np.float32) / 255.0 - mean) / std
        elif img.dtype != np.uint8:
            raise ValueError(f"{name} is {img.dtype}, not uint8: rerun with "
                             "--host-preprocess for float sources")
        else:
            out = img
        if canvas is not None:
            h, w = out.shape[:2]
            ch, cw = canvas
            if h > ch or w > cw:
                raise ValueError(f"{name} is {h}x{w}, larger than the "
                                 f"--canvas {ch}x{cw}")
            if sizes is not None:
                sizes[name] = (h, w)
            out = np.pad(out, ((0, ch - h), (0, cw - w), (0, 0)))
        return out

    return preprocess


def run_serving(predict, names, preprocess, out_dir: str, batch_size: int,
                device: torch.device, workers: int = 2, writers: int = 2,
                raw_output: bool = False, sizes=None) -> dict:
    """Stream ``names`` through ``predict``, write the predictions (each
    cropped back to its ``sizes`` entry, in the writer threads), and
    return throughput stats.  Timing starts after a one-batch warmup and
    covers the whole pipeline, host decode and writes included; on the
    card the record adds the device's idle share of that window."""
    from concurrent.futures import ThreadPoolExecutor

    from scaleprotoseg_torch.serving.engine import ServingEngine

    os.makedirs(out_dir, exist_ok=True)
    engine = ServingEngine(predict, batch_size, preprocess=preprocess,
                           workers=workers, device=device)

    def write_one(name, pred):
        stem = os.path.splitext(name)[0]
        if sizes is not None and name in sizes:
            h, w = sizes[name]
            pred = pred[:h, :w]
        if raw_output:
            np.save(os.path.join(out_dir, f"{stem}.npy"),
                    pred.astype(np.uint8))
        else:
            from PIL import Image   # only for PNGs: --raw-output needs none
            Image.fromarray(pred.astype(np.uint8)).convert("L").save(
                os.path.join(out_dir, f"{stem}.png"))

    for _ in engine.run((n, n) for n in names[:batch_size]):
        pass
    engine.device_seconds = 0.0
    t0 = time.perf_counter()
    count = 0
    with ThreadPoolExecutor(max(1, writers)) as pool:
        pending = []
        for name, pred in engine.run((n, n) for n in names):
            pending.append(pool.submit(write_one, name, pred))
            count += 1
            if len(pending) > 2 * writers:   # bound memory; surface errors
                pending.pop(0).result()
        for fut in pending:
            fut.result()
    dt = time.perf_counter() - t0
    idle = 1.0 - engine.device_seconds / dt \
        if device.type == "cuda" and dt else None
    return {"images": count, "seconds": dt,
            "img_per_s": count / dt if dt else None,
            "device_idle_share": idle,
            "batch_size": batch_size, "output_dir": out_dir}


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name", nargs="?")
    p.add_argument("training_phase", nargs="?")
    p.add_argument("--artifact", help="serving artifact directory "
                   "(instead of MODEL_NAME PHASE)")
    p.add_argument("--export", help="write a serving artifact here and exit")
    p.add_argument("--input", required=True, help="image directory")
    p.add_argument("--output", help="prediction directory "
                   "(default <input>/predictions)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--limit", type=int)
    p.add_argument("--margin", type=int, default=0,
                   help="pixels cropped off each side of every image")
    p.add_argument("--canvas", type=int, nargs=2, metavar=("H", "W"),
                   help="serve mixed-size images: pad each to H x W (one "
                   "program), crop each prediction back")
    p.add_argument("--workers", type=int, default=2,
                   help="decode/preprocess threads")
    p.add_argument("--writers", type=int, default=2,
                   help="prediction-write threads")
    p.add_argument("--raw-output", action="store_true",
                   help="write .npy label arrays instead of PNGs")
    p.add_argument("--results-root", help="override settings results dir")
    p.add_argument("--host-preprocess", action="store_true",
                   help="normalize on the host (float32) instead of on the "
                   "device; implied by --canvas and by float image sources")
    p.add_argument("--no-fast", action="store_true",
                   help="disable the fused-kernel fast path")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the float32 "
                   "plain path)")
    q = p.add_mutually_exclusive_group()
    q.add_argument("--quant8", action="store_true",
                   help="dynamic w8a8 int8 layer4/5 convs (serves without "
                   "the fast path)")
    q.add_argument("--quant8-static", action="store_true",
                   help="static-scale w8a8 int8 layer4/5 convs, calibrated "
                   "on the first --calib-images inputs")
    p.add_argument("--calib-images", type=int, default=8,
                   help="calibration inputs for --quant8-static")
    p.add_argument("--dynamic-batch", action="store_true",
                   help="export with a symbolic batch dimension (plain "
                   "path)")
    p.add_argument("--platforms",
                   help="comma-separated export platforms among cpu,cuda: "
                   "build the artifact on one host type, serve it on "
                   "another (plain path)")
    p.add_argument("--mesh", type=int, default=1,
                   help="data-parallel serving over N devices (not ported: "
                   "N > 1 is refused)")
    args = p.parse_args(argv)

    names = _list_images(args.input, args.limit)
    canvas = tuple(args.canvas) if args.canvas else None
    sizes = {} if canvas else None
    raw0 = _load(os.path.join(args.input, names[0]))
    if args.margin:
        raw0 = raw0[args.margin:-args.margin, args.margin:-args.margin]
    h, w = canvas if canvas else raw0.shape[:2]
    device_pre = not (args.host_preprocess or canvas
                      or raw0.dtype != np.uint8)
    if args.platforms and not args.export:
        p.error("--platforms shapes the exported artifact; pass --export")
    if args.dynamic_batch and not args.export:
        p.error("--dynamic-batch shapes the exported artifact; pass --export")
    if args.mesh > 1:
        p.error("--mesh serves over several cards, which the port does not "
                "do yet (ROADMAP.md Queue 1 item 7)")

    from scaleprotoseg_torch.device import resolve_device
    device = resolve_device(args.device)
    quant8 = "static" if args.quant8_static else args.quant8
    if args.artifact:
        from scaleprotoseg_torch.serving.export import load_artifact
        served = load_artifact(args.artifact, device)
        if (h, w) != tuple(served.input_shape[1:3]):
            raise ValueError(f"images are {h}x{w} but the artifact was "
                             f"exported for {served.input_shape[1:3]}")
        b = served.input_shape[0]
        batch = args.batch if b is None else b
        # the artifact dictates the preprocess split: a uint8 program
        # normalizes on the device, a float one takes normalized input
        if served.meta["input"]["device_normalize"] and (
                args.host_preprocess or canvas):
            p.error("this artifact normalizes on the device (uint8 input); "
                    "--host-preprocess and --canvas need a host-normalized "
                    "artifact: export again with --host-preprocess")
        device_pre = served.meta["input"]["device_normalize"]
        predict, dtype = served.predict, served.input_dtype
        extra = served.meta["extra"]
        fast, quant8 = extra.get("fast"), extra.get("quant8")
    else:
        if not (args.model_name and args.training_phase):
            p.error("need MODEL_NAME TRAINING_PHASE or --artifact")
        from scaleprotoseg_torch.model_loading import (
            calibrate_quant_scales, load_model, resolve_checkpoint)
        fast = (not args.no_fast and device.type == "cuda"
                and not args.platforms and not args.dynamic_batch)
        dtype = torch.bfloat16 if fast else torch.float32
        model_path = os.path.join(args.results_root or settings.results_dir(),
                                  args.model_name)
        ckpt = resolve_checkpoint(model_path, args.training_phase)
        model, spec = load_model(model_path, ckpt, dtype=dtype, fast=fast,
                                 device=device, quant8=quant8)
        if quant8 == "static":
            calib = _make_preprocess(args.input, args.margin, canvas,
                                     sizes={}, normalize=True)
            batches = (torch.from_numpy(calib(n))[None].to(device, dtype)
                       for n in names[:max(args.calib_images, 1)])
            calibrate_quant_scales(model, batches, log=print)
        if args.export:
            from scaleprotoseg_torch.serving.export import (export_serving,
                                                            save_artifact)
            platforms = args.platforms.split(",") if args.platforms \
                else None
            exported = export_serving(
                model, height=h, width=w,
                batch=None if args.dynamic_batch else args.batch,
                input_dtype=dtype, fast=fast, platforms=platforms,
                device_preprocess=device_pre)
            save_artifact(args.export, exported, spec=spec,
                          extra={"model_path": model_path,
                                 "checkpoint": ckpt, "fast": fast,
                                 "quant8": quant8})
            record = {"exported": args.export,
                      "input": [None if args.dynamic_batch else args.batch,
                                h, w, 3],
                      "platforms": list(exported.platforms)}
            print(json.dumps(record))
            return record
        from scaleprotoseg_torch.serving.export import make_serving_fn
        fn = make_serving_fn(model, fast=fast,
                             normalize_to=dtype if device_pre else None)
        if device_pre:
            predict = fn
        else:
            predict = lambda x: fn(x.to(dtype))  # noqa: E731
        batch = args.batch

    wire = np.uint8 if device_pre else np.float32
    preprocess = _make_preprocess(args.input, args.margin, canvas, sizes,
                                  normalize=not device_pre)
    out_dir = args.output or os.path.join(args.input, "predictions")
    record = run_serving(predict, names,
                         lambda n: np.asarray(preprocess(n), wire), out_dir,
                         batch, device, workers=args.workers,
                         writers=args.writers, raw_output=args.raw_output,
                         sizes=sizes)
    record.update(preprocess="device" if device_pre else "host",
                  fast=bool(fast) and quant8 is not True, quant8=quant8,
                  artifact=args.artifact, device=str(device),
                  device_name=(torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"))
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
