"""A seeded COCO-format folder for tests and smoke runs:

    python -m cvnets_tpu_torch.tools.coco_corpus <root> [n_train n_val max_side seed]

writes ``<root>/{train2017,val2017}/*.jpg`` and
``<root>/annotations/instances_{train,val}2017.json``: images of random sizes
(the longer side up to ``max_side``) with a few filled rectangles, each
rectangle an annotation of one of ``CATEGORY_IDS`` (not contiguous, as
COCO's), some of them crowd boxes, one image of each split with no
annotation, and one training file cut short before its frame header, which no
decoder reads. Each annotation also has a polygon ``segmentation`` inside its
box: one star-shaped polygon, one with a hole (an inner polygon, which the
even-odd fill leaves out) or two parts side by side, in turn. The polygons
come from a generator of their own, seeded by (seed, 1), so the images and
boxes are those the seed gave before polygons were added. Needs Pillow and
numpy.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

import numpy as np

CATEGORY_IDS = (1, 3, 7, 12, 18)


def _star(rng: np.random.Generator, cx: float, cy: float, rx: float, ry: float,
          n: int = 8) -> List[float]:
    """A polygon whose ``n`` points sit at sorted angles about (cx, cy), at
    0.5-1 of the radii: x1, y1, x2, y2, ..."""
    angles = np.sort(rng.uniform(0.0, 2 * np.pi, n))
    radius = rng.uniform(0.5, 1.0, n)
    pts = np.stack([cx + rx * radius * np.cos(angles), cy + ry * radius * np.sin(angles)], -1)
    return [round(float(v), 2) for v in pts.reshape(-1)]


def _segmentation(rng: np.random.Generator, kind: int, x: float, y: float, bw: float,
                  bh: float) -> List[List[float]]:
    """Polygons inside the box (x, y, bw, bh): one, one with a hole, or two parts."""
    cx, cy = x + bw / 2, y + bh / 2
    if kind == 1:
        return [_star(rng, cx, cy, bw / 2, bh / 2), _star(rng, cx, cy, bw / 8, bh / 8)]
    if kind == 2:
        return [_star(rng, x + bw / 4, cy, bw / 4, bh / 2), _star(rng, x + 3 * bw / 4, cy,
                                                                 bw / 4, bh / 2)]
    return [_star(rng, cx, cy, bw / 2, bh / 2)]


def _split(root: str, split: str, n: int, max_side: int, rng: np.random.Generator,
           damaged: bool, poly_rng: np.random.Generator) -> Dict:
    from PIL import Image

    img_dir = os.path.join(root, f"{split}2017")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        img_id = 1000 + 17 * i  # not contiguous either
        h = int(rng.integers(max_side // 2, max_side + 1))
        w = int(rng.integers(max_side // 2, max_side + 1))
        pixels = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        n_boxes = 0 if i == 1 else int(rng.integers(1, 5))
        for _ in range(n_boxes):
            bw, bh = int(rng.integers(w // 8, w // 2)), int(rng.integers(h // 8, h // 2))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            pixels[y:y + bh, x:x + bw] = rng.integers(0, 256, 3)
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": int(rng.choice(CATEGORY_IDS)),
                "bbox": [float(x), float(y), float(bw), float(bh)], "area": float(bw * bh),
                "iscrowd": int(rng.random() < 0.15),
                "segmentation": _segmentation(poly_rng, len(annotations) % 3, x, y, bw, bh)})
        name = f"{img_id:012d}.jpg"
        path = os.path.join(img_dir, name)
        Image.fromarray(pixels).save(path, quality=90)
        if damaged and i == n - 1:
            with open(path, "rb") as f:
                blob = f.read()
            with open(path, "wb") as f:
                f.write(blob[:20])  # before the frame header
        images.append({"id": img_id, "file_name": name, "height": h, "width": w})
    return {"images": images, "annotations": annotations,
            "categories": [{"id": c, "name": f"class_{c}"} for c in CATEGORY_IDS]}


def write_coco_corpus(root: str, n_train: int = 12, n_val: int = 6, max_side: int = 160,
                      seed: int = 0) -> str:
    """Write the folder (see the module's docstring) and return ``root``."""
    rng, poly_rng = np.random.default_rng(seed), np.random.default_rng([seed, 1])
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split, n, damaged in (("train", n_train, True), ("val", n_val, False)):
        blob = _split(root, split, n, max_side, rng, damaged, poly_rng)
        with open(os.path.join(root, "annotations", f"instances_{split}2017.json"), "w") as f:
            json.dump(blob, f)
    return root


if __name__ == "__main__":
    write_coco_corpus(sys.argv[1], *(int(a) for a in sys.argv[2:6]))
