"""Write ``tests/torch_fixtures/codecs/``: small images encoded by PIL and
``manifest.json`` with the mode, dtype, shape and SHA-256 of PIL's decode
of each (``np.asarray(Image.open(path))``).

``chip_smoke.py`` decodes these files with ``scaleprotoseg_torch.codecs``
on the GPU machine, where no PIL exists, and matches every hash;
``tests/test_torch_codecs.py`` holds the manifest against PIL.  The JPEGs
are at the datasets' sizes (Pascal 500 x 375, COCO 640 x 480, ADE20K
683 x 512, an EM frame 512 x 512).

    python tools/make_codec_fixtures.py
"""

import hashlib
import json
import os

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "torch_fixtures", "codecs")


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth colour fields with soft noise: a photograph's spectrum at a
    few kilobytes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w] / max(h, w)
    chans = [np.sin(6 * x + 2 * c) * np.cos(5 * y - c) * 90 + 128
             for c in range(3)]
    a = np.stack(chans, -1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


def main():
    os.makedirs(OUT, exist_ok=True)
    files = {
        "pascal_420.jpg": (Image.fromarray(scene(375, 500, 0)),
                           dict(quality=75, subsampling=2)),
        "coco_444.jpg": (Image.fromarray(scene(480, 640, 1)),
                         dict(quality=75, subsampling=0)),
        "ade_progressive.jpg": (Image.fromarray(scene(512, 683, 2)),
                                dict(quality=75, progressive=True)),
        "em_gray.jpg": (Image.fromarray(scene(512, 512, 3)[..., 1]),
                        dict(quality=75)),
        "filtered.png": (Image.fromarray(scene(128, 256, 4)), {}),
        "palette.png": (Image.fromarray(
            (scene(375, 500, 5)[..., 0] // 12).astype(np.uint8), "P"), {}),
        "volume_lzw.tif": (Image.fromarray(scene(128, 128, 6)[..., 2]),
                           dict(compression="tiff_lzw")),
    }
    manifest = {}
    for name, (im, kw) in files.items():
        if im.mode == "P":
            im.putpalette(np.random.default_rng(7).integers(
                0, 256, 768).astype(np.uint8).tobytes())
        path = os.path.join(OUT, name)
        im.save(path, **kw)
        ref = np.asarray(Image.open(path))
        manifest[name] = {"mode": Image.open(path).mode,
                          "dtype": str(ref.dtype), "shape": list(ref.shape),
                          "sha256": hashlib.sha256(ref.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({n: os.path.getsize(os.path.join(OUT, n))
                      for n in sorted(os.listdir(OUT))}))


if __name__ == "__main__":
    main()
