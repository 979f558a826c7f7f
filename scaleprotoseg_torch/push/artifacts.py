"""Per-prototype push visualization artifacts.

The port of the JAX package's ``push/artifacts.py``: for every prototype
that push matched, from its winning training image, under a directory
named after its class,

- ``{act_prefix}{p}.npy``: the float32 self-activation map
  ``log((d + 1) / (d + 1e-4))`` at the distance grid;
- ``{img_prefix}-original{p}.png``: the de-normalised image;
- ``{img_prefix}{p}.png``: its crop to the 95th-percentile box of the
  activation upsampled to the image size (cv2's INTER_LINEAR rule);
- ``{img_prefix}-original_with_self_act{p}.png``: ``0.5 * image + 0.3 *
  jet(activation rescaled to [0, 1])``;
- ``{img_prefix}-original_gt_mask{p}.png``: the image dimmed to 30%
  outside the prototype's class;

and ``bb{epoch}.npy`` / ``bb-receptive_field{epoch}.npy``: the (P, 6)
int64 table ``[image, h0, h1, w0, w1, class]``, -1 where unmatched.

One float32 distance forward serves every prototype of a winner image.
The activation is computed on the host in numpy, as the JAX package
computes it; the upsample, the heat map and the image arithmetic run on
the model's device in the same IEEE operations as the JAX package's
numpy (float64 for the images), so the decoded pixels are the same; the
percentile crop runs on the host (``np.percentile``).  PNGs are written
without PIL (``scaleprotoseg_torch.imageio``) by a pool of threads (zlib
releases the GIL); a winner image's ``-original`` PNG and each class's
``-gt_mask`` PNG are encoded once and written for each prototype.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from scaleprotoseg_torch.helpers import find_high_activation_crop, makedir
from scaleprotoseg_torch.imageio import encode_png, jet, rgba_bytes
from scaleprotoseg_torch.ops.prototype import EPSILON
from scaleprotoseg_torch.ops.resize import resize_linear_cv2
from scaleprotoseg_torch.spec import ProtoSpec

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class _Writer:
    """PNG encodes and file writes on a thread pool, at most ``limit``
    outstanding (each holds a full-size image); errors surface.  An
    ``encode`` future runs before the writes that wait on it (the pool
    takes tasks in order), so the pool cannot deadlock."""

    def __init__(self, workers: int, limit: int = 32):
        self.pool = ThreadPoolExecutor(max(1, workers))
        self.limit = limit
        self.pending = []

    def _wait(self, keep: int) -> None:
        while len(self.pending) > keep:
            self.pending.pop(0).result()

    def png(self, path: str, pixels: np.ndarray) -> None:
        self.pending.append(self.pool.submit(_write, path,
                                             lambda: encode_png(pixels)))
        self._wait(self.limit)

    def data(self, path: str, encoded) -> None:
        """Write the bytes an ``encode`` future holds."""
        self.pending.append(self.pool.submit(_write, path, encoded.result))
        self._wait(self.limit)

    def encode(self, pixels: np.ndarray):
        return self.pool.submit(encode_png, pixels)

    def close(self) -> None:
        self._wait(0)
        self.pool.shutdown()


def _write(path: str, make: Callable[[], bytes]) -> None:
    with open(path, "wb") as f:
        f.write(make())


def save_push_artifacts(model, spec: ProtoSpec, push_loader,
                        best_img: np.ndarray, best_flat: np.ndarray,
                        out_dir: str,
                        cls2name: Optional[Dict[int, str]] = None,
                        img_prefix: str = "prototype-img",
                        act_prefix: str = "prototype-self-act",
                        bb_prefix: str = "bb",
                        epoch_number: Optional[int] = None,
                        distances_of: Optional[Callable] = None,
                        log=print) -> np.ndarray:
    """Write the artifacts of every matched prototype (``best_img`` >= 0)
    of ``model`` (its prototypes as they stand: push calls this before it
    moves them) over ``push_loader``'s fixed-order batches; returns the
    (P, 6) bound-box table.  ``distances_of(images)`` replaces the
    model's float32 ``push_forward`` distances when given."""
    from scaleprotoseg_torch.push.push import float32_forward

    P = spec.num_prototypes
    proto_class = np.argmax(spec.class_identity, axis=1)
    cls2name = cls2name or {}
    bound_boxes = np.full((P, 6), -1, np.int64)
    makedir(out_dir)
    by_winner: Dict[int, list] = {}
    for p in range(P):
        if best_img[p] >= 0:
            by_winner.setdefault(int(best_img[p]), []).append(p)
    dev = model.prototype_vectors.device
    if distances_of is None:
        def distances_of(images):
            return model.push_forward(images)[1]
    mean = torch.tensor(_MEAN, dtype=torch.float64, device=dev)
    std = torch.tensor(_STD, dtype=torch.float64, device=dev)
    writer = _Writer(min(8, os.cpu_count() or 1))
    offset = n_saved = 0
    try:
        with float32_forward(model), torch.no_grad():
            for images, targets in push_loader:
                wanted = [w for w in range(offset, offset + len(images))
                          if w in by_winner]
                if wanted:
                    d = distances_of(torch.from_numpy(np.asarray(images))
                                     .to(dev)).float().cpu().numpy()
                    for w in wanted:
                        i = w - offset
                        n_saved += _render_image(
                            writer, d[i], np.asarray(images[i]),
                            np.asarray(targets[i]), w, by_winner[w],
                            proto_class, cls2name, bound_boxes, out_dir,
                            img_prefix, act_prefix, mean, std, dev)
                offset += len(images)
    finally:
        writer.close()

    suffix = "" if epoch_number is None else str(epoch_number)
    np.save(os.path.join(out_dir, f"{bb_prefix}{suffix}.npy"), bound_boxes)
    np.save(os.path.join(out_dir, f"{bb_prefix}-receptive_field{suffix}.npy"),
            bound_boxes)
    log(f"push artifacts: saved {n_saved} prototype visualizations")
    return bound_boxes


def _render_image(writer: _Writer, dist: np.ndarray, image: np.ndarray,
                  target: np.ndarray, w: int, protos, proto_class, cls2name,
                  bound_boxes, out_dir, img_prefix, act_prefix, mean, std,
                  dev) -> int:
    """The artifacts of the prototypes ``protos`` that image ``w`` won;
    ``dist`` is its (gh, gw, Pa) float32 distance map."""
    disp = torch.clamp(torch.from_numpy(image).to(dev).double() * std + mean,
                       0, 1)
    ih, iw = disp.shape[:2]
    target = torch.from_numpy(target).to(dev)
    acts = np.stack([np.log((dist[:, :, p] + 1) / (dist[:, :, p] + EPSILON))
                     for p in protos])
    ups = resize_linear_cv2(torch.from_numpy(acts).to(dev), ih, iw)
    original_px = rgba_bytes(disp)
    original = writer.encode(original_px)
    masked: Dict[int, object] = {}
    for j, p in enumerate(protos):
        c = int(proto_class[p])
        cls_dir = os.path.join(out_dir, str(cls2name.get(c, f"class_{c}")))
        makedir(cls_dir)
        up = ups[j]
        up_host = up.cpu().numpy()
        y0, y1, x0, x1 = find_high_activation_crop(up_host)
        bound_boxes[p] = [w, y0, y1, x0, x1, c]

        np.save(os.path.join(cls_dir, f"{act_prefix}{p}.npy"), acts[j])
        writer.data(os.path.join(cls_dir, f"{img_prefix}-original{p}.png"),
                    original)
        writer.png(os.path.join(cls_dir, f"{img_prefix}{p}.png"),
                   np.ascontiguousarray(original_px[y0:y1, x0:x1]))
        # heat-map overlay: float32 rescale, float64 colours and blend
        lo, hi = up.min(), up.max()
        span = hi - lo
        rescaled = (up - lo) / (span if float(span) > 1e-8 else 1e-8)
        overlay = 0.5 * disp + 0.3 * jet(rescaled)[..., :3]
        writer.png(os.path.join(
            cls_dir, f"{img_prefix}-original_with_self_act{p}.png"),
            rgba_bytes(torch.clamp(overlay, 0, 1)))
        # the image dimmed outside the prototype's class
        if c not in masked:
            gt = (target == c + 1)[..., None].double()
            masked[c] = writer.encode(rgba_bytes(
                torch.clamp(disp * (0.3 + 0.7 * gt), 0, 1)))
        writer.data(os.path.join(
            cls_dir, f"{img_prefix}-original_gt_mask{p}.png"), masked[c])
    return len(protos)
