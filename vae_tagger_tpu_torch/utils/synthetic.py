"""Synthetic shape/color/size/style dataset (the port's copy of
``vae_tagger_tpu/utils/synthetic.py`` and ``scripts/create_test_dataset.py``):

    python -m vae_tagger_tpu_torch.utils.synthetic --output_dir ds \\
        --num_images 100 --img_size 256 --seed 0

Images of {circle, square, triangle, rectangle} x {red, blue, green,
yellow, purple} x {small, medium, large} x {solid, outline, gradient}, with
the ``data.json`` of weighted tag strings and ``tags.csv`` the trainers
read.  For a seed it writes the same files as the JAX package's generator.
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path
from typing import Dict

import numpy as np
from PIL import Image

SHAPE_TAGS = ["circle", "square", "triangle", "rectangle"]
COLOR_TAGS = ["red", "blue", "green", "yellow", "purple"]
SIZE_TAGS = ["small", "medium", "large"]
STYLE_TAGS = ["solid", "outline", "gradient"]
ALL_TAGS = SHAPE_TAGS + COLOR_TAGS + SIZE_TAGS + STYLE_TAGS

_COLOR_RGB = {
    "red": (255, 0, 0),
    "blue": (0, 0, 255),
    "green": (0, 255, 0),
    "yellow": (255, 255, 0),
    "purple": (128, 0, 128),
}
_SIZE_PX = {"small": 30, "medium": 50, "large": 80}


def _shape_sdf(shape: str, img_size: int, half: int) -> np.ndarray:
    """Normalized 'inside-ness' field in [0, 1]: 1 at the center, 0 at the
    boundary, negative outside.  Drives solid/outline/gradient rendering."""
    c = img_size // 2
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
    dx, dy = xx - c, yy - c
    if shape == "circle":
        dist = np.sqrt(dx ** 2 + dy ** 2)
        return 1.0 - dist / half
    if shape == "square":
        dist = np.maximum(np.abs(dx), np.abs(dy))
        return 1.0 - dist / half
    if shape == "rectangle":
        # half-width = size, half-height = size/2
        return 1.0 - np.maximum(np.abs(dx) / half, np.abs(dy) / (half / 2))
    if shape == "triangle":
        # isoceles triangle with apex (c, c-half), base y = c+half
        # barycentric-style half-plane test, normalized by distance to edges
        apex_y, base_y = c - half, c + half
        inside_base = (base_y - yy) / (2 * half)
        # left edge from apex to (c-half, base_y); right mirrored
        left = ((xx - (c - half)) * (apex_y - base_y)
                - (yy - base_y) * (c - (c - half)))
        right = (((c + half) - xx) * (apex_y - base_y)
                 - (yy - base_y) * ((c + half) - c))
        norm = 2 * half * half
        return np.minimum(inside_base,
                          np.minimum(left / norm, right / norm)) * 2.0
    raise ValueError(shape)


def render_shape(shape: str, color: str, size: str, style: str,
                 img_size: int = 256) -> np.ndarray:
    """Render one fixture image as HWC uint8."""
    half = _SIZE_PX[size]
    field = _shape_sdf(shape, img_size, half)
    rgb = np.asarray(_COLOR_RGB[color], dtype=np.float32)
    img = np.full((img_size, img_size, 3), 255.0, dtype=np.float32)

    inside = field > 0
    if style == "solid":
        img[inside] = rgb
    elif style == "outline":
        band = inside & (field < (3.0 / half) * 2)
        img[band] = rgb
    else:  # gradient: intensity grows toward the boundary like the concentric
        # ring rendering of the fixture format
        alpha = np.clip(1.0 - field, 0.0, 1.0)[..., None]
        img = np.where(inside[..., None], rgb * alpha + 0.0 * (1 - alpha), img)
        img[inside & (field >= 1.0)] = 0.0
    return img.astype(np.uint8)


def create_synthetic_dataset(output_dir: str = "test_dataset",
                             num_images: int = 100,
                             img_size: int = 256,
                             seed: int | None = None) -> Dict:
    """Generate the fixture set; returns its paths and counts."""
    rng = random.Random(seed)
    images_dir = Path(output_dir) / "images"
    images_dir.mkdir(parents=True, exist_ok=True)

    data_dict: Dict[str, str] = {}
    tag_counts = {tag: 0 for tag in ALL_TAGS}

    print(f"generating {num_images} synthetic images...")
    for i in range(num_images):
        shape = rng.choice(SHAPE_TAGS)
        color = rng.choice(COLOR_TAGS)
        size = rng.choice(SIZE_TAGS)
        style = rng.choice(STYLE_TAGS)
        selected = [shape, color, size]
        if rng.random() > 0.3:
            selected.append(style)
        # a sprinkle of random co-occurring tags, like real tag noise
        for tag in ALL_TAGS:
            if tag not in selected and rng.random() > 0.9:
                selected.append(tag)
        for tag in selected:
            tag_counts[tag] += 1

        img = render_shape(shape, color, size, style, img_size)
        filename = f"synthetic_{i:04d}.jpg"
        Image.fromarray(img).save(images_dir / filename, quality=90)
        data_dict[f"{output_dir}/images/{filename}"] = ", ".join(
            f"{t}:1.0" for t in selected)
        if (i + 1) % 20 == 0:
            print(f"  generated {i + 1}/{num_images}")

    data_json_path = Path(output_dir) / "data.json"
    with open(data_json_path, "w", encoding="utf-8") as f:
        json.dump(data_dict, f, indent=2, ensure_ascii=False)

    used = [(t, c) for t, c in sorted(tag_counts.items(),
                                      key=lambda x: x[1], reverse=True)
            if c > 0]
    tags_csv_path = Path(output_dir) / "tags.csv"
    with open(tags_csv_path, "w", encoding="utf-8") as f:
        f.write("name,count\n")
        f.writelines(f"{t},{c}\n" for t, c in used)

    print(f"output: {output_dir} -- {num_images} images, {len(used)} tags")
    return {
        "data_json": str(data_json_path),
        "tags_csv": str(tags_csv_path),
        "images_dir": str(images_dir),
        "num_images": num_images,
        "num_tags": len(used),
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.utils.synthetic",
        description="Write a synthetic tagged image dataset.")
    p.add_argument("--output_dir", type=str, default="test_dataset")
    p.add_argument("--num_images", type=int, default=100)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    return create_synthetic_dataset(args.output_dir, args.num_images,
                                    img_size=args.img_size, seed=args.seed)


if __name__ == "__main__":
    main()
