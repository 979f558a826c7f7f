"""The analysis CLIs' figures without matplotlib (the GPU machine has none).

A ``Figure`` is the row of panels the JAX package's scripts draw with
``plt.subplots(1, k)``: each panel a stack of ``imshow`` layers (an RGB
uint8 image as it is; a 2-D map through ``jet`` or ``tab20`` over its own
minimum and maximum, matplotlib's autoscaled ``Normalize``; ``alpha``
blends a layer over the ones below), and a title.  ``savefig`` samples
every panel to ``PANEL_HEIGHT`` rows (nearest, cv2's rule; the map's range
is taken at full size first), sets them side by side ``GAP`` white pixels
apart and writes an RGB PNG through the port's writer, with the titles in
a ``Title`` text chunk.  The JAX figures are three inches a panel at 90
dpi, a Cityscapes image ~125 pixels tall in its panel; what the panels are
drawn from is what matches, not the pixels.  A layer is drawn on its
array's device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from scaleprotoseg_torch import imageio
from scaleprotoseg_torch.analysis.metrics.parts import cv2_nearest_index

PANEL_HEIGHT = 128
GAP = 4
_CMAPS = {"jet": imageio.jet, "tab20": imageio.tab20}


class Figure:
    """One row of ``n`` panels."""

    def __init__(self, n: int):
        self.layers: List[list] = [[] for _ in range(n)]
        self.titles: List[str] = [""] * n

    def imshow(self, i: int, array, cmap: Optional[str] = None,
               alpha: Optional[float] = None) -> None:
        if cmap is not None and cmap not in _CMAPS:
            raise ValueError(f"unknown colour map {cmap!r}")
        self.layers[i].append((array, cmap, alpha))

    def set_title(self, i: int, title: str) -> None:
        self.titles[i] = title

    def savefig(self, path: str, executor=None):
        """Render the panels and write the PNG; with ``executor`` (a
        thread pool: zlib lets go of the interpreter lock) the encoding
        and the write are its job, and its future is returned."""
        panels = [_render(layers) for layers in self.layers]
        width = sum(p.shape[1] for p in panels) + GAP * (len(panels) - 1)
        out = np.full((PANEL_HEIGHT, max(width, 1), 3), 255, np.uint8)
        x = 0
        for p in panels:
            out[:, x:x + p.shape[1]] = p
            x += p.shape[1] + GAP
        text = {"Title": " | ".join(self.titles)}
        if executor is None:
            return imageio.write_png(path, out, text=text)
        return executor.submit(imageio.write_png, path, out, text)


def _layer_rgb(array, cmap) -> torch.Tensor:
    """(PANEL_HEIGHT, w, 3) float32 in [0, 1] of one layer, on the
    array's device."""
    a = torch.as_tensor(array)
    h, w = a.shape[:2]
    pw = max(1, round(w * PANEL_HEIGHT / h))
    iy = torch.tensor(cv2_nearest_index(PANEL_HEIGHT, h), device=a.device)
    ix = torch.tensor(cv2_nearest_index(pw, w), device=a.device)
    if cmap is None:                        # an RGB uint8 image
        return a.index_select(0, iy).index_select(1, ix).float() / 255.0
    x = a.double()
    lo, hi = x.min(), x.max()
    small = x.index_select(0, iy).index_select(1, ix)
    norm = torch.zeros_like(small) if bool(lo == hi) else \
        (small - lo) / (hi - lo)
    return _CMAPS[cmap](norm)[..., :3].float()


def _render(layers) -> np.ndarray:
    """uint8 (PANEL_HEIGHT, w, 3): the layers blended in order, on the
    device of the last one that lives on a card (else the host)."""
    rgbs = [(_layer_rgb(a, c), al) for a, c, al in layers]
    if not rgbs:
        return np.full((PANEL_HEIGHT, PANEL_HEIGHT, 3), 255, np.uint8)
    dev = next((r.device for r, _ in reversed(rgbs)
                if r.device.type != "cpu"), torch.device("cpu"))
    out = None
    for rgb, alpha in rgbs:
        rgb = rgb.to(dev)
        a = 1.0 if alpha is None else alpha
        out = rgb if out is None else out * (1 - a) + rgb * a
    return (out * 255).to(torch.uint8).cpu().numpy()
