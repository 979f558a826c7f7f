"""mIoU / pixel-accuracy evaluation engine.

The port's counterpart of ``scaleprotoseg_tpu/eval/miou.py``: each batch's
logits are upsampled to label resolution and argmaxed (``fast_output``:
K3, the fused upsample-argmax, which never stores the full-resolution
logits; otherwise the gather-form bilinear resize, the reference's own),
void pixels (``label - 1 < 0``) are masked, and a (C, C) confusion matrix
is accumulated on the device in int64 (exact).  The per-batch matrices
stay on the device and are fetched ``DRAIN_EVERY`` batches at a time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from scaleprotoseg_torch.kernels.upsample import fused_upsample_argmax
from scaleprotoseg_torch.ops.resize import bilinear_sample, resize_bilinear


def iou_from_confusion(cm: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """(per-class IoU, mIoU over seen classes, pixel accuracy)."""
    cm = np.asarray(cm, np.float64)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    seen = union > 0
    iou = np.where(seen, inter / np.maximum(union, 1), 0.0)
    miou = float(iou[seen].mean()) if seen.any() else 0.0
    acc = float(inter.sum() / max(cm.sum(), 1))
    return iou, miou, acc


class SegEvaluator:
    """Streaming confusion-matrix evaluator over full-resolution batches.

    ``proto_class``: optional (P,) prototype -> class array of the active
    prototypes.  When given, every batch also adds to the top-K purity
    curve over the whole split: per image, ``N_PURITY_PIXELS`` random
    label-resolution pixels (rows then cols from ``default_rng(0)``); at
    each, the fraction of the K nearest prototypes (distances bilinearly
    upsampled, sampled pointwise) whose class is the pixel's prediction,
    for every K.  ``result()['top_k_purity_percent']`` is the curve."""

    N_PURITY_PIXELS = 100
    DRAIN_EVERY = 64

    def __init__(self, model, num_classes: int, upsample_logits: bool = True,
                 proto_class=None, fast_output: bool = False):
        if proto_class is not None and not upsample_logits:
            # purity pixels are drawn at label resolution
            raise ValueError("proto_class purity requires upsample_logits")
        self.model = model
        self.num_classes = num_classes
        self.upsample = upsample_logits
        self.fast_output = bool(fast_output and upsample_logits)
        self.device = next(model.parameters()).device
        self.proto_class = None if proto_class is None else torch.as_tensor(
            np.asarray(proto_class), dtype=torch.int64, device=self.device)
        self._cm = np.zeros((num_classes, num_classes), np.float64)
        self._purity_sum = None if proto_class is None else \
            np.zeros(len(proto_class), np.float64)
        self._purity_images = 0
        self._purity_rng = np.random.default_rng(0)
        self._pending = []          # (n images, cm, purity or None)

    def predict(self, images, h: int, w: int):
        """(model output, (B, h, w) int64 labels) of one batch."""
        out = self.model(images)
        logits = out.logits
        if self.fast_output:
            return out, fused_upsample_argmax(logits.float().contiguous(), h,
                                              w).long()
        if self.upsample:
            logits = resize_bilinear(logits, h, w)
        return out, logits.argmax(dim=-1)

    @torch.no_grad()
    def _step(self, images, targets, rows, cols):
        h, w = targets.shape[1], targets.shape[2]
        out, pred = self.predict(images, h, w)
        purity = None
        if self.proto_class is not None:
            sd = bilinear_sample(out.distances, rows, cols, h, w)  # (B,n,P)
            bi = torch.arange(pred.shape[0], device=pred.device)[:, None]
            sp = pred[bi, rows, cols]
            order = torch.argsort(sd, dim=-1, stable=True)
            is_cls = (self.proto_class[order] == sp[..., None]).float()
            k = torch.arange(1, sd.shape[-1] + 1, dtype=torch.float32,
                             device=sd.device)
            frac = torch.cumsum(is_cls, dim=-1) / k
            purity = frac.mean(dim=1).sum(dim=0) * 100.0      # (P,)
        c = self.num_classes
        t = targets.long() - 1
        valid = (t >= 0).long().reshape(-1)
        idx = (t.clamp(0, c - 1) * c + pred).reshape(-1)
        cm = torch.zeros(c * c, dtype=torch.int64, device=idx.device) \
            .index_add_(0, idx, valid).reshape(c, c)
        return cm, purity

    def update(self, images, targets) -> None:
        """One batch: (B, H, W, 3) normalized images and (B, H', W') labels
        (0 = void), arrays or tensors."""
        images = torch.as_tensor(images).to(self.device)
        targets = torch.as_tensor(targets).to(self.device)
        b = images.shape[0]
        rows = cols = None
        if self.proto_class is not None:
            n = self.N_PURITY_PIXELS
            rc = [(self._purity_rng.integers(0, targets.shape[1], size=n),
                   self._purity_rng.integers(0, targets.shape[2], size=n))
                  for _ in range(b)]
            rows = torch.as_tensor(np.stack([r for r, _ in rc]),
                                   device=self.device)
            cols = torch.as_tensor(np.stack([q for _, q in rc]),
                                   device=self.device)
        self._pending.append((b, *self._step(images, targets, rows, cols)))
        if len(self._pending) >= self.DRAIN_EVERY:
            self._drain()

    def _drain(self) -> None:
        if not self._pending:
            return
        cms = torch.stack([cm for _, cm, _ in self._pending]).cpu().numpy()
        self._cm += cms.astype(np.float64).sum(0)
        if self._purity_sum is not None:
            pur = torch.stack([p for _, _, p in self._pending]).cpu().numpy()
            self._purity_sum += pur.astype(np.float64).sum(0)
            self._purity_images += sum(b for b, _, _ in self._pending)
        self._pending = []

    @property
    def cm(self) -> np.ndarray:
        """The confusion matrix so far (pending batches fetched first)."""
        self._drain()
        return self._cm

    def result(self) -> Dict:
        self._drain()
        iou, miou, acc = iou_from_confusion(self._cm)
        out = {"per_class_iou": iou.tolist(), "mean_iou": miou,
               "pixel_accuracy": acc}
        if self._purity_sum is not None and self._purity_images:
            out["top_k_purity_percent"] = (
                self._purity_sum / self._purity_images).tolist()
            out["purity_images"] = self._purity_images
        return out
